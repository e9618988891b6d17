"""Model assembly for the pure-attention, dense-MLP families.

Counterpart of ``repro.models.transformer``.  The parameter tree has the
same nested-dict layout as the reference: layers are grouped into periods
and each period position's blocks are stacked on a leading ``nb`` axis, so
``params["blocks"][p]["attn"]["wq"]`` is (nb, d_model, q_dim) in both
packages and the weight bridge (:mod:`repro_torch.weights`) is a plain
mapping.  Where the reference runs the stacked blocks under ``lax.scan``,
the port loops over them in Python, indexing block ``b`` of every stacked
tensor (a view, no copy).

Decode caches are the stacked :class:`KVCacheView` per period position;
:func:`decode_step` updates them **in place** (the reference returns new
caches and relies on buffer donation).

Other families (MoE, SSM, hybrid, VLM, audio) raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from . import attention as attn_mod
from .attention import KVCacheView
from .layers import embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm

_OTHER_FAMILIES = (
    "only the pure-attention dense-MLP families are ported; the {family} "
    "family waits for ROADMAP.md Queue 1 item 13 (other model families)")


# ---------------------------------------------------------------------------
# Period structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str           # "attn" ("ssm" arrives with the SSM family)
    mlp: Optional[str]   # "mlp" ("moe" arrives with the MoE family)


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None:
        raise NotImplementedError(_OTHER_FAMILIES.format(family=cfg.family))


def period_len(cfg) -> int:
    _check_family(cfg)
    return 1


def period_structure(cfg) -> List[LayerSpec]:
    """Layer specs for positions 0..P-1 of one period."""
    return [LayerSpec(mixer="attn", mlp="mlp") for _ in range(period_len(cfg))]


def n_blocks(cfg) -> int:
    return cfg.n_layers // period_len(cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_one_layer(gen, cfg, spec: LayerSpec, device):
    p: Dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, cfg.dtype, device=device)}
    p["attn"] = attn_mod.init_attention(gen, cfg, device=device)
    p["ln2"] = init_rmsnorm(cfg.d_model, cfg.dtype, device=device)
    p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype,
                        kind=cfg.mlp_kind, device=device)
    return p


def _stack(trees: List[Any]):
    """Stack a list of identically-shaped nested dicts on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)


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
        _stack([_init_one_layer(gen, cfg, spec, dev) for _ in range(nb)])
        for spec in specs
    ]
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_padded, cfg.d_model,
                                           cfg.dtype, device=dev)
    return params


# ---------------------------------------------------------------------------
# Shared block application
# ---------------------------------------------------------------------------


def _apply_layer_train(lp, spec: LayerSpec, x, cfg, *, positions, impl,
                       causal: bool = True):
    """One layer, full-sequence (prefill shape).  Returns (x, (k, v))."""
    h = rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
    y, kv = attn_mod.self_attention(lp["attn"], h, cfg, positions=positions,
                                    causal=causal, impl=impl)
    x = x + y
    h2 = rmsnorm(lp["ln2"], x, eps=cfg.norm_eps)
    x = x + mlp(lp["mlp"], h2, kind=cfg.mlp_kind)
    return x, kv


def _apply_layer_decode(lp, spec: LayerSpec, x, cfg, *, cur_pos, kv_cache,
                        impl):
    """One layer, single-token decode.  Returns (x, kv_cache) with the cache
    views updated in place."""
    h = rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
    y, kv_cache = attn_mod.decode_attention(lp["attn"], h, kv_cache, cur_pos,
                                            cfg, impl=impl)
    x = x + y
    h2 = rmsnorm(lp["ln2"], x, eps=cfg.norm_eps)
    x = x + mlp(lp["mlp"], h2, kind=cfg.mlp_kind)
    return x, kv_cache


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

    kv:    {str(p): KVCacheView stacked over blocks}   (attn positions)
    ssm:   {} until the SSM family is ported
    cross: None until the audio family is ported
    """

    kv: Dict[str, KVCacheView]
    ssm: Dict[str, Any]
    cross: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None


def init_caches(cfg, batch: int, max_len: int, *, device="cpu") -> Caches:
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    kv = {}
    for p, _ in enumerate(specs):
        one = attn_mod.init_kv_cache(cfg, batch, max_len, device=device)
        kv[str(p)] = KVCacheView(
            *(t[None].expand((nb,) + t.shape).clone() for t in one))
    return Caches(kv=kv, ssm={})


def _block_cache(view: KVCacheView, b: int) -> KVCacheView:
    return KVCacheView(k=view.k[b], v=view.v[b], pos=view.pos[b])


def prefill(params, tokens, cfg, *, max_len: int, positions=None,
            impl: str = "cuda"):
    """Run the full prompt, returning (last-token logits, seeded Caches).

    The KV buffers are sized ``min(max_len, window)``; prompt K/V are
    scattered in ring-buffer order (see serving.kv_cache.seed_kv_cache).
    """
    from ..serving.kv_cache import seed_kv_cache

    specs = period_structure(cfg)
    x = embed(params["embed"], tokens)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    ys: Dict[str, List] = {str(p): [] for p in range(len(specs))}
    for b in range(n_blocks(cfg)):
        for p, spec in enumerate(specs):
            x, kv = _apply_layer_train(
                _index(params["blocks"][p], b), spec, x, cfg,
                positions=positions, impl=impl)
            ys[str(p)].append(kv)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = logits_fn(params, x[:, -1:, :], cfg)[:, 0]
    kv = {}
    for p in ys:
        k = torch.stack([k for k, _ in ys[p]])
        v = torch.stack([v for _, v in ys[p]])
        kv[p] = seed_kv_cache(cfg, k, v, max_len=max_len, seq_positions=positions)
    return logits, Caches(kv=kv, ssm={})


def decode_step(params, tokens, caches: Caches, cur_pos, cfg, *,
                impl: str = "cuda"):
    """One decode step.  tokens: (B,) int32; cur_pos: (B,) int32 absolute
    position.  Returns (logits (B, Vp), caches) — the same Caches object,
    its KV tensors updated in place."""
    specs = period_structure(cfg)
    x = embed(params["embed"], tokens)[:, None, :]     # (B, 1, d)
    for b in range(n_blocks(cfg)):
        for p, spec in enumerate(specs):
            x, _ = _apply_layer_decode(
                _index(params["blocks"][p], b), spec, x, cfg, cur_pos=cur_pos,
                kv_cache=_block_cache(caches.kv[str(p)], b), impl=impl)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = logits_fn(params, x, cfg)[:, 0]
    return logits, caches


__all__ = [
    "Caches", "LayerSpec", "decode_step", "init_caches", "init_params",
    "logits_fn", "n_blocks", "period_len", "period_structure", "prefill",
    "unembed_weight",
]
