"""Model assembly for every family: pure attention (dense MLP or
Mixture-of-Experts), the attention-free SSM (Mamba-2), the hybrid (Mamba-2
with attention every ``attn_every`` layers and MoE every ``moe.every``,
Jamba), the VLM (a dense backbone with M-RoPE over a patch-embedding stub,
Qwen2-VL) and audio (an encoder-decoder over a frame-embedding stub,
Whisper).

Counterpart of ``repro.models.transformer``.  The parameter tree has the
same nested-dict layout as the reference: layers are grouped into periods
of ``P = lcm(attn_every, moe.every)`` layers and each period position's
blocks are stacked on a leading ``nb`` axis, so
``params["blocks"][p]["attn"]["wq"]`` is (nb, d_model, q_dim) in both
packages and the weight bridge (:mod:`repro_torch.weights`) is a plain
mapping.  Where the reference runs the stacked blocks under ``lax.scan``,
the port loops over them in Python, indexing block ``b`` of every stacked
tensor (a view, no copy).  A MoE layer (``LayerSpec(mlp="moe")``) takes the
grouped dispatch on the prefill shape and the dense decode path for a
decode step and a verify window (:mod:`repro_torch.models.moe`).

The VLM's prompt is ``extra_embeds`` (patch embeddings) followed by the
token embeddings, at (3, B, S) M-RoPE positions; decode passes plain (B,)
positions, broadcast to the three streams.  The audio family runs
:func:`encoder_forward` (non-causal) over the stub frames, and every
decoder layer attends to the encoder's K/V (``Caches.cross``, made once a
request by :func:`prefill`); sinusoidal positions are added at embed and
at decode.

Decode caches are the stacked :class:`KVCacheView` per attention period
position, or the stacked :class:`PagedKVView` page pool
(:func:`init_paged_caches`), and the stacked :class:`SSMState` per SSM
position; :func:`decode_step` and :func:`verify_step` (a window of draft
tokens in one pass) update them **in place** (the reference returns new
caches and relies on buffer donation).

Training runs :func:`forward` (the whole sequence, differentiable, each
period of layers under the ``remat`` policy) and :func:`lm_loss` (the
cross-entropy over sequence chunks); ``repro_torch.training`` builds the
step from them.

``prefill``, ``prefill_kv``, ``prefix_prefill``, ``decode_step`` and
``verify_step`` take the reference's ``policy=None`` hook: an activation
policy called on activations by the reference's rule names (``"hidden"``
and ``"hidden_decode"`` after the embedding, ``"attn_out"`` and
``"mlp_out"`` on each layer's outputs before the residual add,
``"residual"`` after it, and ``"logits"`` on the serving steps' logits).
Tensor-parallel serving passes ``distributed.sharding.TP_POLICY``, which
sums the shards' partial outputs at ``"attn_out"`` and ``"mlp_out"``.
The SPMD policy (``distributed.spmd.ActivationPolicy``, on one rank of a
mesh) also has ``embed`` (the vocab-parallel lookup), ``layer`` (the
gathers at the start of each layer, which also tell the hooks which of the
layer's outputs are partial sums), ``layer_cfg`` (the rank's heads) and
the length-sharded decode cache (``models.attention.decode_attention``);
an SSM mixer, a MoE and the encoder take it too, and the decoder's
cross-attention output is summed at ``"cross_out"`` (a rule name the
reference's GSPMD program needs none for).  Training's ``forward`` and
:func:`lm_loss` run under it too, with the port's entry hooks
(``"attn_in"``, ``"mlp_in"``, ``"cross_in"``, ``"enc_in"``,
``"logits_in"``: the identity forward, a sum over "model" of the
gradient backward, where a replicated tensor enters split compute) and
the vocab-parallel cross-entropy.  Every entry point runs under it: ``prefill``, ``prefill_kv`` and ``decode_step`` on dense caches for
every family; ``prefix_prefill``, the paged ``decode_step`` and
``verify_step`` on the rank's rows and heads, the pool writes of the paged
paths all-gathered over the data axes first (``pool_rows``; the layout is
in ``distributed.spmd``'s docstring), and under ``kv_len_sharded`` the
paged and verify attention keep the reference's refusal.  Without a
policy nothing changes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device, torch_dtype
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import KVCacheView
from .layers import embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm
from .ssm import SSMState

# ---------------------------------------------------------------------------
# Period structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str           # "attn" | "ssm"
    mlp: Optional[str]   # "mlp" | "moe" | None (SSM blocks carry their own
                         # gating)


def period_len(cfg) -> int:
    p = 1
    if cfg.family == "hybrid":
        p = cfg.attn_every
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return p


def period_structure(cfg) -> List[LayerSpec]:
    """Layer specs for positions 0..P-1 of one period.  A hybrid SSM layer
    carries a MoE FFN on a MoE position and no FFN elsewhere; Mamba-2
    blocks (the SSM family) carry their own gating and never an FFN."""
    specs = []
    for i in range(period_len(cfg)):
        mixer = "attn" if cfg.is_attn_layer(i) else "ssm"
        moe = cfg.is_moe_layer(i)
        if cfg.family == "ssm":
            m = None
        elif cfg.family == "hybrid" and mixer == "ssm":
            m = "moe" if moe else None
        else:
            m = "moe" if moe else "mlp"
        specs.append(LayerSpec(mixer=mixer, mlp=m))
    return specs


def n_blocks(cfg) -> int:
    return cfg.n_layers // period_len(cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_one_layer(gen, cfg, spec: LayerSpec, device, *, cross: bool = False):
    p: Dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, cfg.dtype, device=device)}
    if spec.mixer == "attn":
        p["attn"] = attn_mod.init_attention(gen, cfg, device=device)
    else:
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device=device)
    if cross:
        p["ln_x"] = init_rmsnorm(cfg.d_model, cfg.dtype, device=device)
        p["cross"] = attn_mod.init_attention(gen, cfg, cross=True,
                                             device=device)
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
    On ``device="meta"`` the tree holds shapes and dtypes only (no
    generator exists for meta tensors, and none is needed).
    """
    dev = resolve_device(device)
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, cfg.dtype,
                                device=dev),
        "final_norm": init_rmsnorm(cfg.d_model, cfg.dtype, device=dev),
    }
    cross = cfg.family == "audio"
    params["blocks"] = [
        _stacked_blocks(lambda: _init_one_layer(gen, cfg, spec, dev,
                                                cross=cross), nb)
        for spec in specs
    ]
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_padded, cfg.d_model,
                                           cfg.dtype, device=dev)
    if cfg.family == "audio":
        params["encoder"] = {
            "blocks": [_stacked_blocks(
                lambda: _init_one_layer(gen, cfg, _ENC_SPEC, dev),
                cfg.n_enc_layers)],
            "final_norm": init_rmsnorm(cfg.d_model, cfg.dtype, device=dev),
        }
    return params


# ---------------------------------------------------------------------------
# Shared block application
# ---------------------------------------------------------------------------


_ENC_SPEC = LayerSpec(mixer="attn", mlp="mlp")     # an audio encoder layer


def _sinusoid(positions, d_model: int):
    """Sinusoidal embedding of integer ``positions`` (..., S) -> (..., S,
    d_model) f32, computed on the fly (no host table)."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                     / max(half - 1, 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _shard(x, policy, name: str):
    """The activation policy's rule ``name`` on ``x`` (the identity without
    a policy): a tensor-parallel program sums its shards' partial
    ``"attn_out"`` and ``"mlp_out"`` here, before the residual add."""
    return policy(x, name) if policy is not None else x


def _embed(params, tokens, policy):
    """The vocab-parallel lookup when the policy has one (an SPMD rank);
    the plain take otherwise."""
    if policy is not None and hasattr(policy, "embed"):
        return policy.embed(params["embed"]["w"], tokens)
    return embed(params["embed"], tokens)


def _layer(params, p: int, b: int, policy, *, encoder: bool = False,
           key: Optional[str] = None):
    """Block ``b`` of period position ``p``'s stacked params (of the audio
    encoder's with ``encoder``), through the SPMD policy's per-layer
    gathers where it has them; with ``key`` only that part of the layer
    (its ``"cross"`` attention)."""
    lp = _index((params["encoder"] if encoder else params)["blocks"][p], b)
    if key is not None:
        lp = {key: lp[key]}
    if policy is not None and hasattr(policy, "layer"):
        lp = policy.layer(lp, p, encoder=encoder)
    return lp if key is None else lp[key]


def _layer_cfg(cfg, policy):
    """The config each layer runs with: the rank's heads under an SPMD
    policy that splits them, else ``cfg``."""
    if policy is not None and hasattr(policy, "layer_cfg"):
        return policy.layer_cfg(cfg)
    return cfg


def _ffn(lp, spec: LayerSpec, x, cfg, *, decode: bool, policy=None):
    """The layer's second half: RMS norm of the residual stream ``x``, its
    MLP or MoE, added back to ``x``.  ``decode=False`` on the prefill shape
    (grouped MoE dispatch), ``decode=True`` for a decode step or a verify
    window (dense MoE), as the reference picks them.  Returns (x, the MoE
    load-balance loss: 0.0 for an MLP and on the dense MoE path)."""
    h2 = rmsnorm(lp["ln2"], x, eps=cfg.norm_eps)
    aux = 0.0
    if spec.mlp == "moe":
        # the router reads h2 whole; the MoE enters its split compute itself
        y2, aux = moe_mod.moe_apply(lp["moe"], h2, cfg, decode=decode,
                                    policy=policy)
    else:
        y2 = mlp(lp["mlp"], _shard(h2, policy, "mlp_in"), kind=cfg.mlp_kind)
    y2 = _shard(y2, policy, "mlp_out")
    if not decode:
        y2 = _shard(y2, policy, "residual")
    return x + y2, aux


def _apply_layer_train(lp, spec: LayerSpec, x, cfg, *, positions, impl,
                       causal: bool = True, prefix_kv=None, enc_kv=None,
                       policy=None):
    """One layer, full-sequence (train and prefill shape).  Returns (x,
    aux, state): the MoE load-balance loss (0.0 without a MoE), and the
    layer's (k, v) for an attention layer or its :class:`SSMState` after
    the last token for an SSM layer.  ``enc_kv`` is the layer's
    cross-attention K/V over the encoder (audio decoder layers)."""
    h = _shard(rmsnorm(lp["ln1"], x, eps=cfg.norm_eps), policy, "attn_in")
    if spec.mixer == "attn":
        y, state = attn_mod.self_attention(
            lp["attn"], h, cfg, positions=positions, causal=causal, impl=impl,
            prefix_kv=prefix_kv)
    else:
        y, state = ssm_mod.ssm_forward(lp["ssm"], h, cfg, impl=impl,
                                       return_state=True, policy=policy)
    x = x + _shard(_shard(y, policy, "attn_out"), policy, "residual")
    if enc_kv is not None and "cross" in lp:
        x = _cross(lp, x, enc_kv, cfg, impl, policy)
    aux = 0.0
    if spec.mlp is not None:
        x, aux = _ffn(lp, spec, x, cfg, decode=False, policy=policy)
    return x, aux, state


def _cross(lp, x, enc_kv, cfg, impl, policy=None):
    """The decoder layer's cross-attention over the encoder, added to x
    (a rank's partial sum over its heads summed at ``"cross_out"``)."""
    hx = _shard(rmsnorm(lp["ln_x"], x, eps=cfg.norm_eps), policy, "cross_in")
    y = attn_mod.cross_attention(lp["cross"], hx, enc_kv, cfg, impl=impl)
    return x + _shard(y, policy, "cross_out")


def _apply_layer_decode(lp, spec: LayerSpec, x, cfg, *, cur_pos, cache,
                        impl, page_table, write_target, cross_kv=None,
                        policy=None):
    """One layer, single-token decode.  ``cache`` is the layer's KV view
    (attention) or :class:`SSMState` (SSM); returns (x, cache) with the
    cache updated in place.  With ``page_table`` an attention cache is a
    page pool and ``write_target`` the step's (page, offset) of the new
    token.  ``cross_kv`` is the layer's encoder K/V (audio)."""
    h = rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
    if spec.mixer == "ssm":
        y, cache = ssm_mod.ssm_decode(lp["ssm"], h, cache, cfg,
                                      policy=policy)
    elif page_table is not None:
        y, cache = attn_mod.paged_decode_attention(
            lp["attn"], h, cache, cur_pos, page_table, cfg, write_target,
            impl=impl, policy=policy)
    else:
        y, cache = attn_mod.decode_attention(lp["attn"], h, cache, cur_pos,
                                             cfg, impl=impl, policy=policy)
    x = x + _shard(y, policy, "attn_out")
    if cross_kv is not None and "cross" in lp:
        x = _cross(lp, x, cross_kv, cfg, impl, policy)
    if spec.mlp is not None:
        x, _ = _ffn(lp, spec, x, cfg, decode=True, policy=policy)
    return x, cache


def encoder_forward(params, frames, cfg, *, impl: str = "cuda",
                    remat: str = "none", policy=None):
    """Audio encoder over stub frame embeddings (B, S_enc, d): sinusoidal
    positions, then ``n_enc_layers`` non-causal attention + MLP layers and
    the encoder's final norm.  ``remat`` checkpoints each layer for
    training (:func:`_remat_wrap`).  Under an SPMD ``policy`` the frames
    are the rank's rows and each layer runs as a decoder layer does (the
    rank's heads, the output-split MLP, their sums)."""
    enc = params["encoder"]
    S = frames.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=frames.device)[None, :]
    x = frames + _sinusoid(pos, cfg.d_model).to(frames.dtype)
    lcfg = _layer_cfg(cfg, policy)

    def body(x, b):
        return _apply_layer_train(_layer(params, 0, b, policy, encoder=True),
                                  _ENC_SPEC, x, lcfg, positions=pos,
                                  impl=impl, causal=False, policy=policy)[0]

    body_w = _remat_wrap(body, remat)
    for b in range(cfg.n_enc_layers):
        x = body_w(x, b)
    return rmsnorm(enc["final_norm"], x, eps=cfg.norm_eps)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpoint of ``remat="dots"``: keep the outputs of the
    products without a batch dimension (``aten.mm`` / ``aten.addmm``: the
    projections, the MLP, the LM head), recompute everything else, as the
    reference's ``dots_with_no_batch_dims_saveable`` does."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, remat: str):
    """``fn`` under the training path's activation checkpoint: ``"none"``
    keeps it as it is, ``"full"`` saves only its inputs and recomputes the
    rest in the backward, ``"dots"`` also keeps the outputs of its matrix
    products (:func:`_dots_policy`).  The reference checkpoints a period's
    body; so does :func:`forward`."""
    if remat == "none":
        return fn
    import torch.utils.checkpoint as ckpt

    if remat == "full":
        return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda *args: ckpt.checkpoint(fn, *args, use_reentrant=False,
                                             context_fn=ctx)
    raise ValueError(f"unknown remat policy {remat!r}; expected none, dots "
                     f"or full")


# ---------------------------------------------------------------------------
# Forward (train) and the chunked loss
# ---------------------------------------------------------------------------


class FwdOut(NamedTuple):
    hidden: torch.Tensor
    aux: torch.Tensor          # MoE load-balance loss (0 for non-MoE)


def forward(params, tokens, cfg, *, positions=None, extra_embeds=None,
            enc_out=None, impl: str = "torch", policy=None,
            remat: str = "none", causal: bool = True) -> FwdOut:
    """Full-sequence forward to the final hidden states, differentiable.

    tokens:       (B, S_txt) int32.
    extra_embeds: (B, S_vis, d) patch embeddings prepended to the token
                  embeddings (VLM stub frontend); ``positions`` is then
                  (3, B, S_vis + S_txt) M-RoPE ids.
    enc_out:      (B, S_enc, d) encoder output (audio): every decoder
                  layer's cross-attention K/V is made from it.

    Each period of layers runs under ``remat`` (:func:`_remat_wrap`), the
    reference's checkpoint of its ``lax.scan`` body.  ``impl`` as in
    :data:`~repro_torch.models.attention.ATTN_CAPABILITIES`' ``"train"``
    row when gradients are taken.  Returns :class:`FwdOut` (hidden, the
    layers' summed MoE load-balance loss)."""
    specs = period_structure(cfg)
    x = _shard(_embed_prompt(params, tokens, cfg, extra_embeds, policy),
               policy, "hidden")
    positions = _positions(x, positions)
    lcfg = _layer_cfg(cfg, policy)
    if enc_out is not None:
        enc_out = _shard(enc_out, policy, "enc_in")

    def body(x, aux, b):
        for p, spec in enumerate(specs):
            lp = _layer(params, p, b, policy)
            enc_kv = None
            if enc_out is not None:
                enc_kv = attn_mod.encode_cross_kv(lp["cross"], enc_out, lcfg)
            x, aux_p, _ = _apply_layer_train(
                lp, spec, x, lcfg, positions=positions, impl=impl,
                enc_kv=enc_kv, causal=causal, policy=policy)
            aux = aux + aux_p
        return x, aux

    body_w = _remat_wrap(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(n_blocks(cfg)):
        x, aux = body_w(x, aux, b)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return FwdOut(hidden=x, aux=aux)


# ---------------------------------------------------------------------------
# LM head
# ---------------------------------------------------------------------------


def unembed_weight(params, cfg):
    return params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"]


def logits_fn(params, hidden, cfg):
    return hidden @ unembed_weight(params, cfg).T


def lm_loss(params, hidden, labels, cfg, *, chunk: int = 1024,
            policy=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of (B, S) ``labels`` under ``hidden``'s logits, labels
    < 0 ignored, over chunks of ``chunk`` positions so the (B, S, V) logits
    are never made at once in the forward (autograd keeps each chunk's f32
    logits for the backward).  Returns (sum of the losses f32, count of
    valid labels int32).  Under an SPMD ``policy`` whose vocab is split
    over "model" (``vocab_parallel``) each rank holds its rows of the
    table and the loss is the vocab-parallel cross-entropy
    (:func:`_vocab_parallel_loss`); otherwise the logits are whole and the
    policy changes nothing here."""
    w = unembed_weight(params, cfg)               # (Vp, d)
    if getattr(policy, "vocab_parallel", False) and hasattr(policy,
                                                            "model_max"):
        return _vocab_parallel_loss(w, hidden, labels, chunk, policy)
    S = hidden.shape[1]
    ck = min(chunk, S)
    sums, counts = [], []
    for lo in range(0, S, ck):
        h, lab = hidden[:, lo:lo + ck], labels[:, lo:lo + ck]
        logits = (h @ w.T).float()                # (B, ck, Vp)
        lz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            lab.clamp(min=0).long()[..., None])[..., 0]
        valid = lab >= 0
        sums.append(torch.where(valid, lz - gold, 0.0).sum())
        counts.append(valid.sum())
    return torch.stack(sums).sum(), torch.stack(counts).sum().to(torch.int32)


def _vocab_parallel_loss(w, hidden, labels, chunk: int, policy):
    """:func:`lm_loss` on one "model" rank's rows ``w`` (Vp / model, d) of
    the table, never gathering a chunk's logits: each row's log-sum-exp is
    its max over "model" (no gradient; it cancels) plus the log of the sum
    of the ranks' ``exp(logits - max)``, and its gold logit comes from the
    rank holding the label, the other ranks adding 0; the two sums travel
    in one f32 sum over "model" (``"loss-sum"``, whose backward is the
    identity: every rank holds the whole loss).  The hidden state enters
    the split product through ``"logits_in"``."""
    hidden = policy(hidden, "logits_in")
    vloc = w.shape[0]
    first = policy.vocab_offset(vloc)
    S = hidden.shape[1]
    ck = min(chunk, S)
    sums, counts = [], []
    for lo in range(0, S, ck):
        h, lab = hidden[:, lo:lo + ck], labels[:, lo:lo + ck]
        logits = (h @ w.T).float()                # (B, ck, Vp / model)
        m = policy.model_max(logits.detach().amax(dim=-1), "loss-max")
        local = lab.long() - first
        ok = (local >= 0) & (local < vloc)
        gold = torch.gather(logits, -1, local.clamp(0, vloc - 1)[..., None])
        both = policy.model_sum(torch.stack(
            [torch.exp(logits - m[..., None]).sum(dim=-1),
             torch.where(ok, gold[..., 0], 0.0)], dim=-1), "loss-sum")
        lz = m + torch.log(both[..., 0])
        valid = lab >= 0
        sums.append(torch.where(valid, lz - both[..., 1], 0.0).sum())
        counts.append(valid.sum())
    return torch.stack(sums).sum(), torch.stack(counts).sum().to(torch.int32)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------


class Caches(NamedTuple):
    """Decode-time state, aligned with the period structure.

    kv:    {str(p): KVCacheView or PagedKVView stacked over blocks}
           (attention positions)
    ssm:   {str(p): SSMState stacked over blocks} (SSM positions)
    cross: {str(p): (k, v) stacked over blocks} | None (audio: the
           decoder's cross-attention K/V over the encoder output)
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


def _init_cross_caches(cfg, specs, batch: int, device):
    """Zeroed cross-attention K/V (audio; seeded by prefill), else None."""
    if cfg.family != "audio":
        return None
    shape = (n_blocks(cfg), batch, cfg.enc_seq, cfg.n_kv_heads, cfg.d_head)
    dt = torch_dtype(cfg.dtype)
    return {str(p): (torch.zeros(shape, dtype=dt, device=device),
                     torch.zeros(shape, dtype=dt, device=device))
            for p in range(len(specs))}


def init_caches(cfg, batch: int, max_len: int, *, device="cuda") -> Caches:
    device = resolve_device(device)
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    kv = {str(p): _stacked(attn_mod.init_kv_cache(cfg, batch, max_len,
                                                  device=device), nb)
          for p, spec in enumerate(specs) if spec.mixer == "attn"}
    return Caches(kv=kv, ssm=_init_ssm_caches(cfg, specs, batch, device),
                  cross=_init_cross_caches(cfg, specs, batch, device))


def init_paged_caches(cfg, batch: int, n_pages: int, page_size: int, *,
                      device="cuda") -> Caches:
    """Decode caches with the attention layers backed by one shared page
    pool (:class:`~repro_torch.models.attention.PagedKVView`, stacked over
    blocks) instead of per-slot dense buffers.  The per-slot page *table*
    lives with the slot bookkeeping (``serving.engine.PageState``), not in
    the cache tree.  SSM states stay dense per slot (``batch`` of them):
    they are fixed-size per sequence, so there is nothing to page; so do
    the audio family's cross-attention K/V."""
    device = resolve_device(device)
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    kv = {str(p): _stacked(attn_mod.init_paged_kv_cache(
              cfg, n_pages, page_size, device=device), nb)
          for p, spec in enumerate(specs) if spec.mixer == "attn"}
    return Caches(kv=kv, ssm=_init_ssm_caches(cfg, specs, batch, device),
                  cross=_init_cross_caches(cfg, specs, batch, device))


def _block_cache(view, b: int):
    """Block ``b`` of a stacked cache view (views, no copies)."""
    return type(view)(*(t[b] for t in view))


def _embed_prompt(params, tokens, cfg, extra_embeds, policy=None):
    """Token embeddings, after the VLM's patch embeddings when given; the
    audio family adds sinusoidal positions."""
    x = _embed(params, tokens, policy)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    if cfg.family == "audio":
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x = x + _sinusoid(pos[None, :], cfg.d_model).to(x.dtype)
    return x


def _cross_kv(params, enc_out, cfg, policy=None):
    """{str(p): (k, v)} stacked over blocks, (nb, B, S_enc, Hkv, dh): every
    decoder layer's cross-attention K/V over ``enc_out``.  The stacked
    tensors are allocated once and filled block by block, so no more than
    one layer's K/V is alive beside them (as in :func:`_stacked_blocks`).
    Under an SPMD ``policy`` they are the rank's rows and heads."""
    nb = n_blocks(cfg)
    lcfg = _layer_cfg(cfg, policy)
    out = {}
    for p in range(len(params["blocks"])):
        for b in range(nb):
            k, v = attn_mod.encode_cross_kv(
                _layer(params, p, b, policy, key="cross"), enc_out, lcfg)
            if b == 0:
                out[str(p)] = (k.new_empty((nb,) + k.shape),
                               v.new_empty((nb,) + v.shape))
            out[str(p)][0][b].copy_(k)
            out[str(p)][1][b].copy_(v)
            del k, v
    return out


def _prefill_layers(params, x, cfg, *, positions, impl, cross=None,
                    policy=None):
    """Run the embedded prompt ``x`` (B, S, d) through every layer.
    Returns (last-token logits, {str(p): (k, v)} with k/v (nb, B, S, Hkv,
    dh) in absolute-position order for the attention positions, {str(p):
    SSMState stacked over blocks} for the SSM positions).  Each layer's SSM
    state is copied into the stacked tensors as soon as it is made, so no
    layer's conv input stays alive through the rest of the prompt.
    ``cross`` is :func:`_cross_kv`'s output (audio)."""
    specs = period_structure(cfg)
    nb = n_blocks(cfg)
    lcfg = _layer_cfg(cfg, policy)
    ys: Dict[str, List] = {str(p): [] for p, spec in enumerate(specs)
                           if spec.mixer == "attn"}
    ssm: Dict[str, SSMState] = {}
    x = _shard(x, policy, "hidden")
    for b in range(nb):
        for p, spec in enumerate(specs):
            enc_kv = None
            if cross is not None:
                enc_kv = (cross[str(p)][0][b], cross[str(p)][1][b])
            x, _, state = _apply_layer_train(
                _layer(params, p, b, policy), spec, x, lcfg,
                positions=positions, impl=impl, enc_kv=enc_kv, policy=policy)
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
    logits = _shard(logits_fn(params, x[:, -1:, :], cfg)[:, 0], policy,
                    "logits")
    kv = {p: (torch.stack([k for k, _ in ys[p]]),
              torch.stack([v for _, v in ys[p]])) for p in ys}
    return logits, kv, ssm


def _positions(x, positions):
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)[None, :]
    return positions


def prefill_kv(params, tokens, cfg, *, positions=None, impl: str = "cuda",
               policy=None):
    """Run the full prompt, returning (last-token logits, {str(p): (k, v)},
    {str(p): SSMState}): k/v (nb, B, S, Hkv, dh) in absolute-position
    order — what paged admission packs into pool pages directly (the
    reference seeds a prompt-sized dense cache and reads it back, an
    identity placement) — and each SSM position's state after the last
    prompt token, stacked over blocks (empty for a pure-attention arch),
    which stays dense per slot.  Needs an attention layer (an SSM-only
    arch has no K/V to page)."""
    if all(s.mixer != "attn" for s in period_structure(cfg)):
        raise ValueError("prefill_kv needs an attention layer: an SSM-only "
                         "arch has no K/V to page; use prefill")
    return _prefill_layers(params, _embed(params, tokens, policy), cfg,
                           positions=_positions(tokens, positions), impl=impl,
                           policy=policy)


def prefill(params, tokens, cfg, *, max_len: int, positions=None,
            extra_embeds=None, enc_out=None, impl: str = "cuda", policy=None):
    """Run the full prompt, returning (last-token logits, seeded Caches).

    tokens:       (B, S_txt) int32.
    extra_embeds: (B, S_vis, d) patch embeddings prepended to the token
                  embeddings (VLM stub frontend); ``positions`` is then
                  (3, B, S_vis + S_txt) M-RoPE ids.
    enc_out:      (B, S_enc, d) encoder output (audio): its cross K/V is
                  computed once and returned as ``Caches.cross``.

    The KV buffers are sized ``min(max_len, window)``; prompt K/V are
    scattered in ring-buffer order (see serving.kv_cache.seed_kv_cache).
    SSM layers hand over their state after the last prompt token
    (serving.kv_cache.seed_ssm_state).
    """
    from ..serving.kv_cache import seed_kv_cache, seed_ssm_state

    x = _embed_prompt(params, tokens, cfg, extra_embeds, policy)
    positions = _positions(x, positions)
    cross = (_cross_kv(params, enc_out, cfg, policy) if enc_out is not None
             else None)
    logits, ys, ssm = _prefill_layers(params, x, cfg, positions=positions,
                                      impl=impl, cross=cross, policy=policy)
    # a length-sharded cache holds this rank's block of ring slots
    block = policy.kv_block(cfg, max_len) if hasattr(policy, "kv_block") else None
    kv = {p: seed_kv_cache(cfg, k, v, max_len=max_len, seq_positions=positions,
                           block=block)
          for p, (k, v) in ys.items()}
    return logits, Caches(kv=kv, ssm={p: seed_ssm_state(st)
                                      for p, st in ssm.items()},
                          cross=cross)


def prefix_prefill(params, tokens, prefix_kv, cfg, *, prefix_len: int,
                   impl: str = "cuda", policy=None):
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
    depends on every prompt token, so there is no per-page prefix to reuse,
    and audio/VLM prompts carry non-token context that shifts positions.
    """
    specs = period_structure(cfg)
    if any(s.mixer != "attn" for s in specs):
        raise ValueError(
            "prefix_prefill requires a pure-attention arch (SSM state is "
            "not positional — there is no per-page prefix to reuse)")
    if cfg.family in ("audio", "vlm"):
        raise ValueError(
            f"prefix_prefill does not support the {cfg.family} family")
    x = _shard(_embed(params, tokens, policy), policy, "hidden")
    B, S, _ = x.shape
    positions = prefix_len + torch.arange(S, dtype=torch.int32,
                                          device=x.device)[None, :]
    lcfg = _layer_cfg(cfg, policy)
    ys: Dict[str, List] = {str(p): [] for p in range(len(specs))}
    for b in range(n_blocks(cfg)):
        for p, spec in enumerate(specs):
            pk, pv = prefix_kv[str(p)]
            x, _, kv = _apply_layer_train(
                _layer(params, p, b, policy), spec, x, lcfg,
                positions=positions, impl=impl, prefix_kv=(pk[b], pv[b]),
                policy=policy)
            ys[str(p)].append(kv)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = _shard(logits_fn(params, x[:, -1:, :], cfg)[:, 0], policy,
                    "logits")
    out = {p: (torch.stack([k for k, _ in ys[p]]),
               torch.stack([v for _, v in ys[p]])) for p in ys}
    return logits, out


def decode_step(params, tokens, caches: Caches, cur_pos, cfg, *,
                impl: str = "cuda", page_table=None, policy=None):
    """One decode step.  tokens: (B,) int32; cur_pos: (B,) int32 absolute
    position.  Returns (logits (B, Vp), caches) — the same Caches object,
    its KV and SSM tensors updated in place.

    With ``page_table`` (B, max_pages) the attention caches are page pools
    (:func:`init_paged_caches`); the table is read-only here — page
    allocation happens in the caller (the chunk loop or admission)."""
    specs = period_structure(cfg)
    x = _embed(params, tokens, policy)[:, None, :]     # (B, 1, d)
    if cfg.family == "audio":
        x = x + _sinusoid(cur_pos[:, None], cfg.d_model).to(x.dtype)
    x = _shard(x, policy, "hidden_decode")
    lcfg = _layer_cfg(cfg, policy)
    cross = caches.cross or {}
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
            ck = cross.get(str(p))
            x, _ = _apply_layer_decode(
                _layer(params, p, b, policy), spec, x, lcfg, cur_pos=cur_pos,
                cache=_block_cache(stacked, b), impl=impl,
                page_table=page_table, write_target=target,
                cross_kv=None if ck is None else (ck[0][b], ck[1][b]),
                policy=policy)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    logits = _shard(logits_fn(params, x, cfg)[:, 0], policy, "logits")
    return logits, caches


def verify_step(params, tokens, caches: Caches, cur_pos, cfg, *,
                impl: str = "cuda", page_table=None, write_limit=None,
                policy=None):
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
    x = _shard(_embed(params, tokens, policy), policy,
               "hidden_decode")                        # (B, W, d)
    lcfg = _layer_cfg(cfg, policy)
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
            lp = _layer(params, p, b, policy)
            view = _block_cache(caches.kv[str(p)], b)
            h = rmsnorm(lp["ln1"], x, eps=cfg.norm_eps)
            if page_table is not None:
                y, _ = attn_mod.paged_verify_attention(
                    lp["attn"], h, view, cur_pos, page_table, lcfg, target,
                    impl=impl, policy=policy)
            else:
                y, _ = attn_mod.verify_decode_attention(
                    lp["attn"], h, view, cur_pos, lcfg, impl=impl,
                    write_limit=write_limit, policy=policy)
            x = x + _shard(y, policy, "attn_out")
            if spec.mlp is not None:
                x, _ = _ffn(lp, spec, x, lcfg, decode=True, policy=policy)
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
    return _shard(logits_fn(params, x, cfg), policy, "logits"), caches


__all__ = [
    "Caches", "FwdOut", "LayerSpec", "decode_step", "encoder_forward",
    "forward", "init_caches", "init_paged_caches", "init_params", "lm_loss",
    "logits_fn", "n_blocks", "period_len", "period_structure", "prefill",
    "prefill_kv", "prefix_prefill", "unembed_weight", "verify_step",
]
