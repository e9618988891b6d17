"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels are built
with ``nvcc`` at the first launch); elsewhere they skip.  Run them on the
GPU machine with::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no ``jax``, so it also runs where JAX is not installed.
Tolerances: 1e-4 max abs in f32 with TF32 off (only the summation order
differs) and 2e-2 in bf16 (one rounding of the output to bf16).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,dh,window,q_offset", [
    (8, 256, 256, 16, 8, 128, None, 0),
    (2, 77, 77, 16, 8, 128, None, 0),
    (2, 130, 200, 4, 2, 64, 50, 70),
    (1, 40, 72, 8, 1, 32, 16, 32),
])
def test_flash_attention_kernel_matches_ref(gen, dtype, B, Sq, Sk, H, Hkv, dh,
                                            window, q_offset):
    from repro_torch.kernels.flash_attention import ops, ref

    q = _rand(gen, (B, Sq, H, dh), dtype)
    k = _rand(gen, (B, Sk, Hkv, dh), dtype)
    v = _rand(gen, (B, Sk, Hkv, dh), dtype)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window, q_offset=q_offset)
    want = ref.flash_attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        window=window, q_offset=q_offset).transpose(1, 2)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,Hkv,dh,window,lo,hi,holes", [
    (8, 322, 16, 8, 128, None, 256, 320, 0.0),
    (4, 64, 16, 8, 128, 64, 100, 300, 0.2),
    (3, 100, 16, 1, 64, None, 150, 400, 0.3),
])
def test_decode_attention_kernel_matches_ref(gen, dtype, B, C, H, Hkv, dh,
                                             window, lo, hi, holes):
    from repro_torch.kernels.decode_attention import ops, ref

    rng = np.random.default_rng(0)
    cur = rng.integers(lo, hi, size=B).astype(np.int32)
    c = np.arange(C)[None, :]
    pos = cur[:, None] - ((cur[:, None] - c) % C)
    pos = np.where((pos >= 0) & (rng.random((B, C)) >= holes), pos, -1)
    pos[np.arange(B), cur % C] = cur
    q = _rand(gen, (B, H, dh), dtype)
    k = _rand(gen, (B, C, Hkv, dh), dtype)
    v = _rand(gen, (B, C, Hkv, dh), dtype)
    pos_t = torch.from_numpy(pos.astype(np.int32)).cuda()
    cur_t = torch.from_numpy(cur).cuda()
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, pos_t, cur_t, window=window)
    want = ref.decode_attention_ref(q, k, v, pos_t, cur_t, window=window)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_kernel_wrapper_rejects_bad_inputs(gen):
    from repro_torch.kernels.flash_attention import ops

    def qkv(dh, dtype):
        q = _rand(gen, (1, 8, 4, dh), dtype)
        kv = _rand(gen, (1, 8, 2, dh), dtype)
        return q, kv, kv.clone()

    with pytest.raises(ValueError, match="dh=48"):          # not instantiated
        ops.flash_attention(*qkv(48, torch.float32))
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(*qkv(32, torch.float16))
    q, k, v = qkv(32, torch.float32)
    strided = _rand(gen, (1, 8, 2, 64), torch.float32)[..., :32]
    with pytest.raises(ValueError, match="not contiguous"):
        ops.flash_attention(q, strided, v)


@pytest.mark.parametrize("window", [None, 8])
def test_batcher_on_the_card_matches_the_plain_path(gen, window):
    """Reduced qwen3-0.6b at f32 on the card: the batcher through the
    kernels (the default impl and device) gives the plain path's tokens."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32",
                              sliding_window=window)
    params = init_params(cfg, 0)
    outs = {}
    for impl in ("cuda", "torch"):
        b = ContinuousBatcher(params, cfg, ServingConfig(
            slots=4, prompt_len=12, max_len=30, attn_impl=impl))
        reqs = [Request(rid=i, prompt=np.arange(1, 3 + i, dtype=np.int32),
                        max_new=8 + i) for i in range(6)]
        for r in reqs:
            b.submit(r)
        b.run()
        outs[impl] = [r.out for r in reqs]
    assert outs["cuda"] == outs["torch"]
