"""The benchmark's own arithmetic: quantiles, the card's peaks, a model's
shape read from its configuration file, and the operations and bytes of the
work a window needed, for the whole step and for each attention kernel.

Nothing here imports the program: a later change to the program cannot move
this yardstick.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16_BYTES = 2


def percentile(values: Sequence[float], q: float) -> float:
    """Exact empirical quantile, nearest rank: the element at floor(q * n)
    of the sorted sample, clamped into range; nan on an empty sample."""
    if not values:
        return float("nan")
    vals = sorted(values)
    return vals[min(int(q * len(vals)), len(vals) - 1)]


@dataclasses.dataclass(frozen=True)
class Dims:
    """The shape of a model as its configuration file gives it."""

    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared: int = 0
    dense_layers: int = 0

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


def dims(conf: Dict) -> Dims:
    """Dims from a configuration file's published keys."""
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    return Dims(
        d_model=d, n_layers=conf["num_hidden_layers"], n_heads=h,
        n_kv_heads=conf.get("num_key_value_heads", h),
        d_head=conf.get("head_dim") or d // h,
        d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
        n_experts=conf.get("n_routed_experts", 0) or 0,
        top_k=conf.get("num_experts_per_tok", 0) or 0,
        expert_d_ff=conf.get("moe_intermediate_size", 0) or 0,
        n_shared=conf.get("n_shared_experts", 0) or 0,
        dense_layers=conf.get("first_k_dense_replace", 0) or 0)


def active_params_per_token(m: Dims) -> int:
    """Weights one token meets in the layers under the published routing:
    the attention projections, then the dense MLP or the router, the top-k
    routed experts and the shared experts.  Neither the embedding lookup
    nor the LM head (:func:`head_flops`) is counted; norms are left out."""
    attn = m.d_model * (2 * m.q_dim + 2 * m.kv_dim)
    dense = 3 * m.d_model * m.d_ff
    n = 0
    for i in range(m.n_layers):
        n += attn
        if m.moe and i >= m.dense_layers:
            n += m.d_model * m.n_experts
            n += (m.top_k + m.n_shared) * 3 * m.d_model * m.expert_d_ff
        else:
            n += dense
    return n


def head_flops(m: Dims) -> float:
    """FLOPs of the LM head at one output position."""
    return 2.0 * m.d_model * m.vocab


def attn_flops(m: Dims, context_sum: int) -> float:
    """FLOPs of QK^T and PV in every layer for queries that together see
    ``context_sum`` keys."""
    return 4.0 * m.n_layers * m.n_heads * m.d_head * context_sum


def causal_context(first: int, n: int) -> int:
    """Keys seen by ``n`` causal queries whose first sees ``first`` keys:
    first + (first + 1) + ... + (first + n - 1)."""
    return n * first + n * (n - 1) // 2


@dataclasses.dataclass
class Work:
    """What the traffic required the program to compute: prompt tokens
    (padding and an already-cached shared prefix left out) with the keys
    they attend to, output positions, and decode tokens with theirs."""

    prompt_tokens: int = 0
    prompt_context: int = 0
    outputs: int = 0
    decode_tokens: int = 0
    decode_context: int = 0

    def add_prompt(self, n_new: int, cached: int) -> None:
        """An admission row: ``n_new`` computed prompt tokens after
        ``cached`` tokens already in the cache; it ends in one output."""
        self.prompt_tokens += n_new
        self.prompt_context += causal_context(cached + 1, n_new)
        self.outputs += 1

    def add_decode(self, context: int) -> None:
        """A decode token that attends to ``context`` keys (itself
        included)."""
        self.decode_tokens += 1
        self.decode_context += context
        self.outputs += 1

    def model_flops(self, m: Dims) -> float:
        n = active_params_per_token(m)
        return (2.0 * n * (self.prompt_tokens + self.decode_tokens)
                + head_flops(m) * self.outputs
                + attn_flops(m, self.prompt_context + self.decode_context))


def mfu(work: Work, m: Dims, seconds: float) -> Optional[float]:
    """Share of the card's bf16 peak that the needed model FLOPs fill."""
    if seconds <= 0:
        return None
    return work.model_flops(m) / (seconds * PEAK_BF16_FLOPS)


# -- attention kernels: least time for the work each launch needed --------


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def paged_decode_bound_s(m: Dims, contexts: Iterable[int],
                         page_size: int) -> float:
    """One layer's launch of paged decode over the rows with ``contexts``
    keys each (their real K/V rows): read q, each real K/V row and the page
    table entries that map them once; write the output once."""
    flops = nbytes = 0.0
    for c in contexts:
        flops += 4.0 * m.n_heads * m.d_head * c
        nbytes += (2 * m.q_dim * BF16_BYTES + 2 * c * m.kv_dim * BF16_BYTES
                   + 4 * -(-c // page_size))
    return bound_s(flops, nbytes)


def prefill_attn_bound_s(m: Dims, rows: Iterable[tuple]) -> float:
    """One layer's launch of flash (``cached`` 0) or prefix-flash
    attention over ``rows`` of (n_new, cached): read q, k and v of the new
    tokens and the cached K/V once, write the output once; causal over the
    new tokens, every cached key seen by each."""
    flops = nbytes = 0.0
    for n_new, cached in rows:
        flops += 4.0 * m.n_heads * m.d_head * causal_context(cached + 1,
                                                             n_new)
        nbytes += (n_new * (2 * m.q_dim + 2 * m.kv_dim) * BF16_BYTES
                   + cached * 2 * m.kv_dim * BF16_BYTES)
    return bound_s(flops, nbytes)
