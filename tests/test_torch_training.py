"""The port's training path against the JAX package's on the CPU, at f32:
the flash attention ``autograd.Function`` (its log-sum-exp and gradients)
and the train step on reduced qwen3-0.6b under every route the
reference trains ("xla" as the port's "torch", "flash", "naive"), with
gradient accumulation, both remat policies and both AdamW modes.

Tolerances are stated in ``test_torch_train_parity.py``; the attention-level
ones here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import (  # noqa: F401 (a module fixture)
    assert_port_trees_equal, check_train_parity, configs, one_torch_thread,
    port_steps)
from repro.models import attention as jax_attention
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import attention
from repro_torch.training import TrainerConfig

FLASH_CASES = [(True, None, 0), (False, None, 0), (True, 16, 0), (True, None, 32)]


def _qkv(q_offset, *, B=2, Sq=24, H=4, Hkv=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    Sk = Sq + q_offset
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Sk, Hkv, dh), (B, Sk, Hkv, dh))]


# ---------------------------------------------------------------------------
# the flash autograd.Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,q_offset", FLASH_CASES)
def test_flash_fwd_lse_matches_jax(causal, window, q_offset):
    """The blockwise forward (the CPU route of FlashAttentionFn) and the
    kernel's plain version (``ref``, as ``ops`` routes a CPU tensor) give
    the reference's output and log-sum-exp, in its units and layout
    (B, Sq, H) = (B, Sq, Hkv, group) flattened.  1e-5 (f32, another
    summation order)."""
    q, k, v = _qkv(q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want, want_lse = jax_attention._flash_fwd_lse(
        *map(jnp.asarray, (q, k, v)), block_k=8, **kw)
    want_lse = np.asarray(want_lse).reshape(want_lse.shape[:2] + (-1,))
    out, lse = attention._flash_fwd_lse(*map(torch.from_numpy, (q, k, v)),
                                        block_k=8, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)
    out2, lse2 = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                        return_lse=True, **kw)
    assert lse2.shape == lse.shape and lse2.dtype == torch.float32
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse2.numpy(), want_lse, rtol=1e-5, atol=1e-5)


def test_lse_of_a_row_without_keys_is_the_references():
    """A row whose window holds no key: -1e30 in both packages and in the
    kernel's plain version."""
    q, k, v = _qkv(0, Sq=24)
    k, v = k[:, :8], v[:, :8]              # rows >= 8 + 4 see no key
    kw = dict(causal=True, window=4, q_offset=0)
    _, want = jax_attention._flash_fwd_lse(*map(jnp.asarray, (q, k, v)),
                                           block_k=8, **kw)
    _, lse = attention._flash_fwd_lse(*map(torch.from_numpy, (q, k, v)),
                                      block_k=8, **kw)
    _, lse_ref = fa_ref.flash_attention_ref(
        *(torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)),
        return_lse=True, **kw)
    want = np.asarray(want).reshape(lse.shape)
    assert (want[:, 12:] == -1e30).all()
    np.testing.assert_array_equal(lse.numpy()[:, 12:], want[:, 12:])
    np.testing.assert_array_equal(lse_ref.transpose(1, 2).numpy()[:, 12:],
                                  want[:, 12:])


@pytest.mark.parametrize("causal,window,q_offset", FLASH_CASES)
def test_flash_attention_fn_grads_match_jax(causal, window, q_offset):
    """dq, dk, dv of sum(out^2) through ``FlashAttentionFn`` against
    ``jax.grad`` through ``repro.models.attention.flash_attention_train``
    (the reference's custom VJP), key blocks of 8 (a padded tail at
    q_offset 32 after Sk = 56): 1e-5 (f32)."""
    q, k, v = _qkv(q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_k=8)
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = attention.flash_attention_train(*ins, **kw)
    got = torch.autograd.grad((out ** 2).sum(), ins)
    want = jax.grad(lambda q, k, v: (jax_attention.flash_attention_train(
        q, k, v, **kw) ** 2).sum(), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # and the port's own naive route, as the reference test holds its VJP
    refs = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    naive = attention.naive_attention(*refs, causal=causal, window=window,
                                      q_offset=q_offset)
    for g, w in zip(got, torch.autograd.grad((naive ** 2).sum(), refs)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=2e-4)


def test_flash_train_impl_needs_no_kernel_on_the_cpu():
    """On a CPU tensor the Function runs the plain blockwise forward: the
    kernel's launch counter does not move."""
    q, k, v = _qkv(0)
    before = fa_ops.flash_attention.launches
    attention.flash_attention_train(*map(torch.from_numpy, (q, k, v)))
    assert fa_ops.flash_attention.launches == before


# ---------------------------------------------------------------------------
# the train step on qwen3-0.6b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["torch", "flash", "naive"])
def test_train_step_matches_jax(impl):
    """After 1 and 3 steps; on "torch" also the gradients before the
    first update (the attention routes' own gradients are held above)."""
    check_train_parity("qwen3-0.6b", impl=impl, steps=3,
                       grads=impl == "torch")


@pytest.mark.parametrize("tkw", [
    dict(grad_accum=2, quantize_opt=True, schedule="warmup_cosine", warmup=2,
         total_steps=6, clip_norm=0.5),
    dict(remat="full", attn_impl_="flash"),
    dict(remat="dots", grad_accum=2),
], ids=["grad_accum=2+quantize_opt+warmup_cosine+clip", "remat=full+flash",
        "remat=dots+grad_accum=2"])
def test_train_step_options_match_jax(tkw):
    tkw = dict(tkw)
    impl = tkw.pop("attn_impl_", "torch")
    check_train_parity("qwen3-0.6b", impl=impl, steps=2, grads=False, **tkw)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_no_remat(remat):
    """Checkpointing changes memory, not math: the same losses and params
    as remat="none" within 1e-6 (the backward's sums keep their order)."""
    p0, m0 = port_steps("qwen3-0.6b", attn_impl="flash")
    p1, m1 = port_steps("qwen3-0.6b", attn_impl="flash", remat=remat)
    for a, b in zip(m0, m1):
        assert float(a["loss"]) == float(b["loss"])
        assert float(a["grad_norm"]) == pytest.approx(float(b["grad_norm"]),
                                                      rel=1e-6)
    assert_port_trees_equal(p0, p1, tol=1e-6)


def test_loss_decreases_on_a_fixed_batch():
    """Twelve steps at lr 3e-3 on one batch cut the loss by a quarter, as
    the reference's ``test_loss_decreases_on_fixed_batch`` shows for its
    own."""
    from repro.data.synthetic import make_batch

    from repro_torch.optim import adamw_init
    from repro_torch.training import batch_to_torch, make_train_step
    from repro_torch.weights import params_from_jax

    cfg, jcfg = configs("qwen3-0.6b")
    from repro.models import init_params as jax_init_params

    p = params_from_jax(jax.device_get(jax_init_params(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    o = adamw_init(p)
    step = make_train_step(cfg, TrainerConfig(lr=3e-3, loss_chunk=16,
                                              attn_impl="flash"))
    b = batch_to_torch(make_batch(jcfg, seq_len=32, batch=4, step=0), "cpu")
    losses = []
    for _ in range(12):
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.75 * losses[0], losses


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_cuda_route_is_refused_for_training_as_the_reference_cannot_train_pallas():
    """The port refuses attn_impl="cuda" at construction and names "flash";
    the reference accepts "pallas" but ``jax.grad`` through its Pallas
    kernel fails in the pallas_call JVP rule (interpret mode on the CPU),
    a deliberate difference logged in ROADMAP.md Queue 3."""
    with pytest.raises(ValueError, match="'flash'"):
        TrainerConfig(attn_impl="cuda")
    with pytest.raises(ValueError, match="not supported for mode 'train'"):
        TrainerConfig(attn_impl="xla")

    from repro.data.synthetic import make_batch
    from repro.models import init_params as jax_init_params
    from repro.optim import adamw_init as jax_adamw_init
    from repro.training.steps import TrainerConfig as JaxTrainerConfig
    from repro.training.steps import make_train_step as jax_make_train_step

    _, jcfg = configs("qwen3-0.6b")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in
         make_batch(jcfg, seq_len=16, batch=2, step=0, reduced=True).items()}
    step = jax_make_train_step(jcfg, JaxTrainerConfig(loss_chunk=8,
                                                      attn_impl="pallas"))
    with pytest.raises(AssertionError):
        step(jp, jax_adamw_init(jp), b)


def test_compressed_pod_all_reduce_waits_for_a_pod_mesh():
    """Without a mesh that has a "pod" axis the reference takes its own
    uncompressed branch, and so does the port; over a "pod" mesh without a
    process group (a description) it raises.  The step over a process
    mesh's "pod" axis is held against the reference in
    ``test_torch_spmd.py``."""
    from repro_torch.training import make_train_step

    cfg, _ = configs("qwen3-0.6b")
    tcfg = TrainerConfig(compress_pods=True)
    make_train_step(cfg, tcfg)                         # no mesh: plain

    class PodMesh:
        axis_names = ("pod", "data")
        shape = {"pod": 2, "data": 1}

    with pytest.raises(NotImplementedError, match="needs a process group"):
        make_train_step(cfg, tcfg, mesh=PodMesh())


@pytest.mark.parametrize("quantize", [False, True])
def test_opt_state_crosses_the_weight_bridge_both_ways(quantize):
    """The reference's AdamW state becomes the port's AdamWState / QTensor
    (a NamedTuple rebuilt field by field, which ``type(tree)(generator)``
    could not do) and comes back as numpy that the reference's
    ``adamw_update`` reads by field name, giving the update it gives from
    its own state."""
    from repro.models import init_params as jax_init_params
    from repro.optim import adamw_init as jax_adamw_init
    from repro.optim import adamw_update as jax_adamw_update

    from repro_torch.optim import AdamWState, QTensor
    from repro_torch.weights import opt_state_from_jax, opt_state_to_jax

    _, jcfg = configs("qwen3-0.6b")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), jp)
    _, jo = jax_adamw_update(grads, jax_adamw_init(jp, quantize=quantize), jp,
                             lr=1e-3, quantized=quantize)
    state = opt_state_from_jax(jax.device_get(jo), device="cpu")
    assert isinstance(state, AdamWState) and state.step.dtype == torch.int32
    leaf = state.m["blocks"][0]["attn"]["wq"]
    assert isinstance(leaf, QTensor) if quantize else leaf.dtype == torch.float32
    back = jax.tree.map(jnp.asarray, opt_state_to_jax(state))
    want = jax_adamw_update(grads, jo, jp, lr=1e-3, quantized=quantize)
    got = jax_adamw_update(grads, back, jp, lr=1e-3, quantized=quantize)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
