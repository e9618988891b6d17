"""Model assembly for the pure-attention families (dense MLP or
Mixture-of-Experts) and the attention-free SSM (Mamba-2) family.

Counterpart of ``repro.models.transformer``.  The parameter tree has the
same nested-dict layout as the reference: layers are grouped into periods
and each period position's blocks are stacked on a leading ``nb`` axis, so
``params["blocks"][p]["attn"]["wq"]`` is (nb, d_model, q_dim) in both
packages and the weight bridge (:mod:`repro_torch.weights`) is a plain
mapping.  Where the reference runs the stacked blocks under ``lax.scan``,
the port loops over them in Python, indexing block ``b`` of every stacked
tensor (a view, no copy).  A MoE layer (``LayerSpec(mlp="moe")``) takes the
grouped dispatch on the prefill shape and the dense decode path for a
decode step and a verify window (:mod:`repro_torch.models.moe`).

Decode caches are the stacked :class:`KVCacheView` per attention period
position, or the stacked :class:`PagedKVView` page pool
(:func:`init_paged_caches`), and the stacked :class:`SSMState` per SSM
position; :func:`decode_step` and :func:`verify_step` (a window of draft
tokens in one pass) update them **in place** (the reference returns new
caches and relies on buffer donation).

Other families (hybrid, VLM, audio) raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import KVCacheView
from .layers import embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm
from .ssm import SSMState

_OTHER_FAMILIES = (
    "only the pure-attention (dense MLP or MoE) and the SSM (Mamba-2) "
    "families are ported; the {family} family waits for ROADMAP.md Queue 1 "
    "item 13 (other model families)")


# ---------------------------------------------------------------------------
# Period structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str           # "attn" | "ssm"
    mlp: Optional[str]   # "mlp" | "moe" | None (SSM blocks carry their own
                         # gating)


def _check_family(cfg) -> None:
    ported = ((cfg.family == "dense" and cfg.ssm is None and cfg.moe is None)
              or (cfg.family == "moe" and cfg.ssm is None)
              or (cfg.family == "ssm" and cfg.moe is None))
    if not ported:
        raise NotImplementedError(_OTHER_FAMILIES.format(family=cfg.family))


def period_len(cfg) -> int:
    _check_family(cfg)
    p = 1
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return p


def period_structure(cfg) -> List[LayerSpec]:
    """Layer specs for positions 0..P-1 of one period."""
    specs = []
    for i in range(period_len(cfg)):
        mlp_kind = "moe" if cfg.is_moe_layer(i) else "mlp"
        specs.append(LayerSpec(mixer="attn" if cfg.is_attn_layer(i) else "ssm",
                               mlp=None if cfg.family == "ssm" else mlp_kind))
    return specs


def n_blocks(cfg) -> int:
    return cfg.n_layers // period_len(cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_one_layer(gen, cfg, spec: LayerSpec, device):
    p: Dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, cfg.dtype, device=device)}
    if spec.mixer == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg, device=device)
    else:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device=device)
    if spec.mlp is not None:
        p["ln2"] = init_rmsnorm(cfg.d_model, cfg.dtype, device=device)
        if spec.mlp == "moe":
            p["moe"] = moe_mod.init_moe(gen, cfg, device=device)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype,
                                kind=cfg.mlp_kind, device=device)
    return p


def _stacked_blocks(make_block, nb: int):
    """``nb`` blocks from ``make_block()``, stacked on a new axis 0.  Each
    leaf is allocated once at its stacked size and filled block by block,
    so no more than one block's tree is alive beside the result (a list of
    blocks and then ``torch.stack`` would hold every leaf twice)."""

    def fill(dst, src, b):
        if isinstance(src, dict):
            for key in src:
                fill(dst[key], src[key], b)
        else:
            dst[b].copy_(src)

    def alloc(t):
        if isinstance(t, dict):
            return {key: alloc(v) for key, v in t.items()}
        return t.new_empty((nb,) + tuple(t.shape))

    first = make_block()
    out = alloc(first)
    fill(out, first, 0)
    del first
    for b in range(1, nb):
        fill(out, make_block(), b)
    return out


def _index(tree, b: int):
    """Block ``b`` of a stacked nested dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, b) for k, v in tree.items()}
    return tree[b]


def init_params(cfg, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
    """Full parameter tree with seeded random weights, made on ``device``.

    Same tree, shapes and dtypes as ``repro.models.init_params``; the values
    come from a ``torch.Generator`` seeded with ``seed`` and differ from
    JAX's (tests move JAX's weights across with ``weights.params_from_jax``).
    """
    dev = resolve_device(device)
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, cfg.dtype,
                                device=dev),
        "final_norm": init_rmsnorm(cfg.d_model, cfg.dtype, device=dev),
    }
    params["blocks"] = [
        _stacked_blocks(lambda: _init_one_layer(gen, cfg, spec, dev), nb)
        for spec in specs
    ]
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_padded, cfg.d_model,
                                           cfg.dtype, device=dev)
    return params


# ---------------------------------------------------------------------------
# Shared block application
# ---------------------------------------------------------------------------


def _ffn(lp, spec: LayerSpec, x, cfg, *, decode: bool):
    """The layer's second half: RMS norm of the residual stream ``x``, its
    MLP or MoE, added back to ``x``.  ``decode=False`` on the prefill shape
    (grouped MoE dispatch), ``decode=True`` for a decode step or a verify
    window (dense MoE), as the reference picks them."""
    h2 = rmsnorm(lp["ln2"], x, eps=cfg.norm_eps)
    if spec.mlp == "moe":
        y2, _ = moe_mod.moe_apply(lp["moe"], h2, cfg, decode=decode)
    else:
        y2 = mlp(lp["mlp"], h2, kind=cfg.mlp_kind)
    return x + y2


def _apply_layer_train(lp, spec: LayerSpec, x, cfg, *, positions, impl,
                       causal: bool = True, prefix_kv=None):
    """One layer, full-sequence (prefill shape).  Returns (x, state): the
    layer's (k, v) for an attention layer, its :class:`SSMState` after the
    last token for an SSM layer."""
    h = rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
    if spec.mixer == "attn":
        y, state = attn_mod.self_attention(
            lp["attn"], h, cfg, positions=positions, causal=causal, impl=impl,
            prefix_kv=prefix_kv)
    else:
        y, state = ssm_mod.ssm_forward(lp["ssm"], h, cfg, impl=impl,
                                       return_state=True)
    x = x + y
    if spec.mlp is not None:
        x = _ffn(lp, spec, x, cfg, decode=False)
    return x, state


def _apply_layer_decode(lp, spec: LayerSpec, x, cfg, *, cur_pos, cache,
                        impl, page_table, write_target):
    """One layer, single-token decode.  ``cache`` is the layer's KV view
    (attention) or :class:`SSMState` (SSM); returns (x, cache) with the
    cache updated in place.  With ``page_table`` an attention cache is a
    page pool and ``write_target`` the step's (page, offset) of the new
    token."""
    h = rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
    if spec.mixer == "ssm":
        y, cache = ssm_mod.ssm_decode(lp["ssm"], h, cache, cfg)
    elif page_table is not None:
        y, cache = attn_mod.paged_decode_attention(
            lp["attn"], h, cache, cur_pos, page_table, cfg, write_target,
            impl=impl)
    else:
        y, cache = attn_mod.decode_attention(lp["attn"], h, cache, cur_pos,
                                             cfg, impl=impl)
    x = x + y
    if spec.mlp is not None:
        x = _ffn(lp, spec, x, cfg, decode=True)
    return x, cache


# ---------------------------------------------------------------------------
# LM head
# ---------------------------------------------------------------------------


def unembed_weight(params, cfg):
    return params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"]


def logits_fn(params, hidden, cfg):
    return hidden @ unembed_weight(params, cfg).T


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


class Caches(NamedTuple):
    """Decode-time state, aligned with the period structure.

    kv:    {str(p): KVCacheView or PagedKVView stacked over blocks}
           (attention positions)
    ssm:   {str(p): SSMState stacked over blocks} (SSM positions)
    cross: None until the audio family is ported
    """

    kv: Dict[str, KVCacheView]
    ssm: Dict[str, SSMState]
    cross: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None


def _stacked(one, nb: int):
    """``nb`` copies of a per-layer cache NamedTuple, stacked on axis 0."""
    return type(one)(*(t[None].expand((nb,) + t.shape).clone() for t in one))


def _init_ssm_caches(cfg, specs, batch: int, device):
    nb = n_blocks(cfg)
    return {str(p): _stacked(ssm_mod.init_ssm_state(cfg, batch, device=device),
                             nb)
            for p, spec in enumerate(specs) if spec.mixer == "ssm"}


def init_caches(cfg, batch: int, max_len: int, *, device="cuda") -> Caches:
    device = resolve_device(device)
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    kv = {str(p): _stacked(attn_mod.init_kv_cache(cfg, batch, max_len,
                                                  device=device), nb)
          for p, spec in enumerate(specs) if spec.mixer == "attn"}
    return Caches(kv=kv, ssm=_init_ssm_caches(cfg, specs, batch, device))


def init_paged_caches(cfg, batch: int, n_pages: int, page_size: int, *,
                      device="cuda") -> Caches:
    """Decode caches with the attention layers backed by one shared page
    pool (:class:`~repro_torch.models.attention.PagedKVView`, stacked over
    blocks) instead of per-slot dense buffers.  The per-slot page *table*
    lives with the slot bookkeeping (``serving.engine.PageState``), not in
    the cache tree.  SSM states stay dense per slot (``batch`` of them):
    they are fixed-size per sequence, so there is nothing to page."""
    device = resolve_device(device)
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    kv = {str(p): _stacked(attn_mod.init_paged_kv_cache(
              cfg, n_pages, page_size, device=device), nb)
          for p, spec in enumerate(specs) if spec.mixer == "attn"}
    return Caches(kv=kv, ssm=_init_ssm_caches(cfg, specs, batch, device))


def _block_cache(view, b: int):
    """Block ``b`` of a stacked cache view (views, no copies)."""
    return type(view)(*(t[b] for t in view))


def _prefill_layers(params, tokens, cfg, *, positions, impl):
    """Run the full prompt through every layer.  Returns (last-token
    logits, {str(p): (k, v)} with k/v (nb, B, S, Hkv, dh) in absolute-
    position order for the attention positions, {str(p): SSMState stacked
    over blocks} for the SSM positions).  Each layer's SSM state is copied
    into the stacked tensors as soon as it is made, so no layer's conv
    input stays alive through the rest of the prompt."""
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    x = embed(params["embed"], tokens)
    ys: Dict[str, List] = {str(p): [] for p, spec in enumerate(specs)
                           if spec.mixer == "attn"}
    ssm: Dict[str, SSMState] = {}
    for b in range(nb):
        for p, spec in enumerate(specs):
            x, state = _apply_layer_train(
                _index(params["blocks"][p], b), spec, x, cfg,
                positions=positions, impl=impl)
            if spec.mixer == "attn":
                ys[str(p)].append(state)
                continue
            if str(p) not in ssm:
                ssm[str(p)] = SSMState(*(
                    torch.empty((nb,) + t.shape, dtype=t.dtype, device=t.device)
                    for t in state))
            for dst, src in zip(ssm[str(p)], state):
                dst[b].copy_(src)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = logits_fn(params, x[:, -1:, :], cfg)[:, 0]
    kv = {p: (torch.stack([k for k, _ in ys[p]]),
              torch.stack([v for _, v in ys[p]])) for p in ys}
    return logits, kv, ssm


def _positions(tokens, positions):
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    return positions


def prefill_kv(params, tokens, cfg, *, positions=None, impl: str = "cuda"):
    """Run the full prompt, returning (last-token logits, {str(p): (k, v)})
    with k/v (nb, B, S, Hkv, dh) in absolute-position order — what paged
    admission packs into pool pages directly (the reference seeds a
    prompt-sized dense cache and reads it back, an identity placement).
    Attention-only archs: an SSM layer's state is not K/V (paged mode
    refuses a model without attention; :func:`prefill` seeds SSM state)."""
    if any(s.mixer != "attn" for s in period_structure(cfg)):
        raise ValueError("prefill_kv returns attention K/V only; use prefill "
                         "for an arch with SSM layers")
    logits, kv, _ = _prefill_layers(params, tokens, cfg,
                                    positions=_positions(tokens, positions),
                                    impl=impl)
    return logits, kv


def prefill(params, tokens, cfg, *, max_len: int, positions=None,
            impl: str = "cuda"):
    """Run the full prompt, returning (last-token logits, seeded Caches).

    The KV buffers are sized ``min(max_len, window)``; prompt K/V are
    scattered in ring-buffer order (see serving.kv_cache.seed_kv_cache).
    SSM layers hand over their state after the last prompt token
    (serving.kv_cache.seed_ssm_state).
    """
    from ..serving.kv_cache import seed_kv_cache, seed_ssm_state

    positions = _positions(tokens, positions)
    logits, ys, ssm = _prefill_layers(params, tokens, cfg,
                                      positions=positions, impl=impl)
    kv = {p: seed_kv_cache(cfg, k, v, max_len=max_len, seq_positions=positions)
          for p, (k, v) in ys.items()}
    return logits, Caches(kv=kv, ssm={p: seed_ssm_state(st)
                                      for p, st in ssm.items()})


def prefix_prefill(params, tokens, prefix_kv, cfg, *, prefix_len: int,
                   impl: str = "cuda"):
    """Suffix prefill against a cached prompt prefix (shared-prefix
    admission): run only the uncached tail of the prompt, attending to the
    per-layer prefix K/V gathered from the paged pool.

    tokens:     (B, S_suffix) int32 — the prompt tail, absolute positions
                ``prefix_len + [0, S_suffix)``.
    prefix_kv:  {str(p): (k, v)} with k/v (nb, B, prefix_len, Hkv, dh).

    Returns (last-token logits (B, Vp), {str(p): (k, v)}) where the output
    K/V (nb, B, S_suffix, Hkv, dh) cover only the suffix, in
    absolute-position order.  Causal attention makes the suffix rows
    independent of whether the prefix was recomputed or read back, so this
    reproduces the cold :func:`prefill`'s suffix (exactly when the cache
    dtype is the compute dtype).

    Pure-attention archs only: an SSM layer's state after the prompt
    depends on every prompt token, so there is no per-page prefix to reuse.
    """
    specs = period_structure(cfg)
    if any(s.mixer != "attn" for s in specs):
        raise ValueError(
            "prefix_prefill requires a pure-attention arch (SSM state is "
            "not positional — there is no per-page prefix to reuse)")
    x = embed(params["embed"], tokens)
    B, S, _ = x.shape
    positions = prefix_len + torch.arange(S, dtype=torch.int32,
                                          device=x.device)[None, :]
    ys: Dict[str, List] = {str(p): [] for p in range(len(specs))}
    for b in range(n_blocks(cfg)):
        for p, spec in enumerate(specs):
            pk, pv = prefix_kv[str(p)]
            x, kv = _apply_layer_train(
                _index(params["blocks"][p], b), spec, x, cfg,
                positions=positions, impl=impl, prefix_kv=(pk[b], pv[b]))
            ys[str(p)].append(kv)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = logits_fn(params, x[:, -1:, :], cfg)[:, 0]
    out = {p: (torch.stack([k for k, _ in ys[p]]),
               torch.stack([v for _, v in ys[p]])) for p in ys}
    return logits, out


def decode_step(params, tokens, caches: Caches, cur_pos, cfg, *,
                impl: str = "cuda", page_table=None):
    """One decode step.  tokens: (B,) int32; cur_pos: (B,) int32 absolute
    position.  Returns (logits (B, Vp), caches) — the same Caches object,
    its KV and SSM tensors updated in place.

    With ``page_table`` (B, max_pages) the attention caches are page pools
    (:func:`init_paged_caches`); the table is read-only here — page
    allocation happens in the caller (the chunk loop or admission)."""
    specs = period_structure(cfg)
    x = embed(params["embed"], tokens)[:, None, :]     # (B, 1, d)
    target = None
    if page_table is not None:
        # every layer writes the same (page, offset): compute it once
        pool = next(iter(caches.kv.values())).k          # (nb, P+1, ps, ...)
        target = attn_mod.paged_write_target(
            page_table, cur_pos.to(torch.int32), pool.shape[2],
            pool.shape[1] - 1)
    for b in range(n_blocks(cfg)):
        for p, spec in enumerate(specs):
            stacked = (caches.kv if spec.mixer == "attn" else caches.ssm)[str(p)]
            x, _ = _apply_layer_decode(
                _index(params["blocks"][p], b), spec, x, cfg, cur_pos=cur_pos,
                cache=_block_cache(stacked, b), impl=impl,
                page_table=page_table, write_target=target)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = logits_fn(params, x, cfg)[:, 0]
    return logits, caches


def verify_step(params, tokens, caches: Caches, cur_pos, cfg, *,
                impl: str = "cuda", page_table=None, write_limit=None):
    """Score a window of W candidate tokens in one pass (draft-and-verify).

    tokens: (B, W) int32, the slot's last committed token followed by W-1
    drafted candidates, at absolute positions ``cur_pos + [0, W)``.
    Returns (logits (B, W, Vp), caches), the caches updated in place:
    ``logits[:, j]`` is the next-token distribution after ``tokens[:, j]``,
    what ``decode_step`` gives having decoded the window prefix, because
    causal attention makes query ``j`` depend only on positions ``<=
    cur_pos + j`` (the window's K/V is written before attention reads it).

    With ``page_table`` the caches are page pools: every window position
    writes ``page_table[b, pos // page_size]``, computed once per step for
    all layers, and a position whose page is unmapped or past the table
    writes the trash page (clamped and masked where JAX clamps its gather
    and fills).  Without it, ``write_limit`` (B,) caps how many window
    writes stick in the dense ring (see
    :func:`~repro_torch.models.attention.verify_decode_attention`).

    Pure-attention, non-sliding-window text archs only: SSM state advances
    sequentially and cannot be rolled back, and audio/vlm prompts carry
    non-token context.  MoE layers take the dense decode path over the
    window, as in the reference: decode routing is per token.
    """
    specs = period_structure(cfg)
    if any(s.mixer != "attn" for s in specs):
        raise ValueError(
            "verify_step requires a pure-attention arch (SSM state cannot "
            "be rolled back to the accepted prefix)")
    if cfg.family in ("audio", "vlm"):
        raise ValueError(
            f"verify_step does not support the {cfg.family} family")
    if cfg.sliding_window:
        raise ValueError("verify_step does not support sliding-window archs")
    x = embed(params["embed"], tokens)                 # (B, W, d)
    target = None
    if page_table is not None:
        pool = next(iter(caches.kv.values())).k          # (nb, P+1, ps, ...)
        W = tokens.shape[1]
        pos_w = cur_pos.to(torch.int32)[:, None] + torch.arange(
            W, dtype=torch.int32, device=tokens.device)[None, :]
        target = attn_mod.paged_write_target(page_table, pos_w, pool.shape[2],
                                             pool.shape[1] - 1)
    for b in range(n_blocks(cfg)):
        for p, spec in enumerate(specs):
            lp = _index(params["blocks"][p], b)
            view = _block_cache(caches.kv[str(p)], b)
            h = rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
            if page_table is not None:
                y, _ = attn_mod.paged_verify_attention(
                    lp["attn"], h, view, cur_pos, page_table, cfg, target,
                    impl=impl)
            else:
                y, _ = attn_mod.verify_decode_attention(
                    lp["attn"], h, view, cur_pos, cfg, impl=impl,
                    write_limit=write_limit)
            x = x + y
            if spec.mlp is not None:
                x = _ffn(lp, spec, x, cfg, decode=True)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return logits_fn(params, x, cfg), caches


__all__ = [
    "Caches", "LayerSpec", "decode_step", "init_caches", "init_paged_caches",
    "init_params", "logits_fn", "n_blocks", "period_len", "period_structure",
    "prefill", "prefill_kv", "prefix_prefill", "unembed_weight", "verify_step",
]
