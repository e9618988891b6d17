"""Inference engine: prefill, chunked decode and admission steps, and a host
``generate`` loop, on dense KV caches.

Counterpart of the dense parts of ``repro.serving.engine``.  The contract is
the reference's: :func:`make_decode_chunk` runs ``n_steps`` decode
iterations with the slot bookkeeping (:class:`SlotState`: active mask,
positions, EOS and budget detection) on the device, so a batcher issues one
dispatch and one host sync per chunk instead of per token.  Nothing inside
the T-step loop reads a value back to the host.

Where JAX jits these programs with ``donate_argnums`` so XLA updates the
ring-buffer KV in place, the port updates the caches **in place** directly
(``index_put_`` on views of the stacked cache); PyTorch runs eagerly, so the
reference's ``ProgramRegistry`` of compiled programs has no counterpart.

Invariant: a slot that deactivates mid-chunk (EOS or token budget) keeps
decoding with its position frozen — it overwrites its *own* ring slot with
dead values, which is safe because admission re-seeds the slot's cache from
prefill before it is reused.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import decode_step, prefill
from ..models.attention import check_attn_impl
from ..models.transformer import Caches


@functools.lru_cache(maxsize=32)
def _logit_mask(vocab: int, vocab_padded: int, device: torch.device):
    """Additive mask (Vp,) on ``device`` — 0 on the real vocab, -inf on
    padding.  Built once per device and reused by every step."""
    if vocab_padded <= vocab:
        return None
    m = np.zeros((vocab_padded,), np.float32)
    m[vocab:] = -np.inf
    return torch.from_numpy(m).to(device)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    attn_impl: str = "cuda"      # see models.attention.ATTN_CAPABILITIES
    greedy: bool = True
    temperature: float = 1.0
    chunk: int = 8               # max decode steps fused per dispatch

    def __post_init__(self):
        check_attn_impl(self.attn_impl, "dense")

    def logit_mask(self, cfg, device):
        return _logit_mask(cfg.vocab, cfg.vocab_padded, torch.device(device))


def chunk_bucket(n: int) -> int:
    """Largest power of two ≤ n — the fixed set of chunk/prefill shapes."""
    return 1 << (max(n, 1).bit_length() - 1)


def select_token(logits, mask, scfg: ServeConfig,
                 generator: Optional[torch.Generator] = None):
    """Greedy or sampled next-token selection under the vocab-padding mask.
    ``argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    if scfg.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / scfg.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def make_prefill_step(cfg, scfg: ServeConfig):
    """prefill_step(params, batch) -> (last-token logits, Caches).

    batch: {"tokens": (B, S) int32}."""

    def prefill_step(params, batch):
        return prefill(params, batch["tokens"], cfg, max_len=scfg.max_len,
                       impl=scfg.attn_impl)

    return prefill_step


# ---------------------------------------------------------------------------
# Chunked decode with on-device slot bookkeeping
# ---------------------------------------------------------------------------


class SlotState(NamedTuple):
    """Per-slot decode bookkeeping, resident on the device between chunks.

    tokens:     (B,) int32 — last emitted token (next decode input)
    cur_pos:    (B,) int32 — absolute position the next token writes to
    active:     (B,) bool  — slot is mid-generation
    remaining:  (B,) int32 — decode tokens left until the slot's max budget
    eos:        (B,) int32 — per-slot EOS id, -1 = none
    """

    tokens: torch.Tensor
    cur_pos: torch.Tensor
    active: torch.Tensor
    remaining: torch.Tensor
    eos: torch.Tensor


def init_slot_state(batch: int, *, device="cpu") -> SlotState:
    return SlotState(
        tokens=torch.zeros((batch,), dtype=torch.int32, device=device),
        cur_pos=torch.zeros((batch,), dtype=torch.int32, device=device),
        active=torch.zeros((batch,), dtype=torch.bool, device=device),
        remaining=torch.zeros((batch,), dtype=torch.int32, device=device),
        eos=torch.full((batch,), -1, dtype=torch.int32, device=device),
    )


def make_decode_chunk(cfg, scfg: ServeConfig, n_steps: int):
    """decode_chunk(params, caches, state, generator=None) ->
    (caches, state, tokens (T, B), emitted (T, B), poisoned (B,)).

    ``n_steps`` decode iterations with EOS and token-budget detection on the
    device: a slot that finishes deactivates immediately, its position
    freezes, and later iterations emit nothing for it (``emitted`` is the
    validity mask).  ``poisoned`` is the fault sentinel: a slot whose logits
    come back non-finite is deactivated *before* its token is selected, and
    the check runs on the raw logits, before the additive vocab mask puts
    -inf on the padding.

    The caches are updated **in place** and returned as the same object
    (the reference returns new caches under buffer donation); the slot state
    is returned as new tensors.  No value is read back to the host inside
    the loop.
    """

    def decode_chunk(params, caches: Caches, state: SlotState,
                     generator: Optional[torch.Generator] = None):
        mask = scfg.logit_mask(cfg, state.tokens.device)
        st = state
        poisoned = torch.zeros_like(state.active)
        toks, emitted = [], []
        for _ in range(n_steps):
            logits, caches = decode_step(params, st.tokens, caches, st.cur_pos,
                                         cfg, impl=scfg.attn_impl)
            bad = st.active & ~torch.isfinite(logits).all(dim=-1)
            active = st.active & ~bad
            nxt = select_token(logits, mask, scfg, generator)
            nxt = torch.where(active, nxt, st.tokens)
            remaining = st.remaining - active.to(torch.int32)
            done = active & ((nxt == st.eos) | (remaining <= 0))
            st = SlotState(
                tokens=nxt,
                cur_pos=st.cur_pos + active.to(torch.int32),
                active=active & ~done,
                remaining=remaining,
                eos=st.eos,
            )
            poisoned = poisoned | bad
            toks.append(nxt)
            emitted.append(active)
        return caches, st, torch.stack(toks), torch.stack(emitted), poisoned

    return decode_chunk


def make_admit_step(cfg, scfg: ServeConfig):
    """admit_step(params, batch, caches, state, slots, pos0, budget, eos) ->
    (first_tokens (n,), caches, state).

    Right-sized admission: ``batch["tokens"]`` is (n, S) for the *bucketed*
    number of joining requests — prefill runs over n rows, not the full slot
    count — and the fresh caches are scattered into the resident tree per
    slot.  The resident caches and slot state are updated **in place**
    (``index_put_``; the reference donates them instead) and returned.

    Duplicate entries in ``slots`` are allowed only when they carry
    identical rows (the batcher pads a partial bucket by repeating row 0):
    which duplicate write wins is then irrelevant.
    """
    prefill_step = make_prefill_step(cfg, scfg)

    def admit_step(params, batch, caches: Caches, state: SlotState,
                   slots, pos0, budget, eos):
        logits, fresh = prefill_step(params, batch)
        mask = scfg.logit_mask(cfg, logits.device)
        # admission is greedy: the prompt's continuation token
        if mask is not None:
            logits = logits + mask.to(logits.dtype)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        idx = slots.long()
        for p, old in caches.kv.items():
            new = fresh.kv[p]
            for o, n in zip(old, new):
                o[:, idx] = n.to(o.dtype)
        # the admission token already counts toward the budget; a slot with
        # nothing left (or an immediate EOS) never activates
        remaining = budget - 1
        state.tokens[idx] = nxt
        state.cur_pos[idx] = pos0
        state.active[idx] = (remaining > 0) & (nxt != eos)
        state.remaining[idx] = remaining
        state.eos[idx] = eos
        return nxt, caches, state

    return admit_step


# ---------------------------------------------------------------------------
# Host generate loop (chunked)
# ---------------------------------------------------------------------------


def generate(params, cfg, prompt_tokens, *, n_new: int,
             scfg: Optional[ServeConfig] = None, seed: int = 0,
             device="cuda"):
    """Prefill the prompt, then decode ``n_new`` tokens through the chunked
    path: the remaining budget is covered by power-of-two chunk buckets.

    prompt_tokens: (B, S) int32 (numpy or tensor).  ``params`` must live on
    ``device``.  Returns (B, n_new) int32 on ``device``.
    """
    dev = resolve_device(device)
    if isinstance(prompt_tokens, torch.Tensor):
        tokens = prompt_tokens.to(device=dev, dtype=torch.int32)
    else:
        tokens = torch.from_numpy(np.asarray(prompt_tokens, dtype=np.int32)).to(dev)
    B, S = tokens.shape
    scfg = scfg or ServeConfig(max_len=S + n_new)
    logits, caches = make_prefill_step(cfg, scfg)(params, {"tokens": tokens})
    mask = scfg.logit_mask(cfg, dev)
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)

    out = [tok[:, None]]
    left = n_new - 1
    state = SlotState(
        tokens=tok,
        cur_pos=torch.full((B,), S, dtype=torch.int32, device=dev),
        active=torch.ones((B,), dtype=torch.bool, device=dev),
        remaining=torch.full((B,), max(left, 0), dtype=torch.int32, device=dev),
        eos=torch.full((B,), -1, dtype=torch.int32, device=dev),
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    while left > 0:
        T = chunk_bucket(min(left, max(scfg.chunk, 1)))
        caches, state, toks, _, _ = make_decode_chunk(cfg, scfg, T)(
            params, caches, state, gen)
        out.append(toks.T)
        left -= T
    return torch.cat(out, dim=1)
