"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode and its plain references.

Inputs are made with numpy from a seed and handed to both packages, at f32.
Tolerance 1e-5 abs/rel: the math is the same, only the summation order
differs.  The CUDA kernels themselves run only on a GPU
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jda_ops
from repro.kernels.decode_attention import ref as jda_ref
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

TOL = dict(rtol=1e-5, atol=1e-5)


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ring_pos(rng, cur, C, holes=0.0):
    """pos (B, C) of a ring that has seen positions 0..cur[b]: slot c holds
    the newest p <= cur with p % C == c, or -1; ``holes`` empties slots."""
    c = np.arange(C)[None, :]
    cur = np.asarray(cur)[:, None]
    pos = cur - ((cur - c) % C)
    pos = np.where(pos >= 0, pos, -1)
    if holes:
        pos = np.where(rng.random(pos.shape) < holes, -1, pos)
    return pos.astype(np.int32)


# (B, Sq, Sk, H, Hkv, dh, causal, window, q_offset)
FLASH_CASES = {
    "gqa4:2-dh32-causal": (2, 64, 64, 4, 2, 32, True, None, 0),
    "gqa8:1-window": (1, 48, 48, 8, 1, 32, True, 16, 0),
    "gqa16:8-dh128-offset-raggedSk": (1, 40, 72, 16, 8, 128, True, None, 32),
    "noncausal-ragged": (2, 33, 45, 4, 2, 32, False, None, 0),
    "window-offset": (1, 24, 56, 8, 1, 32, True, 20, 32),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_jax(case):
    B, Sq, Sk, H, Hkv, dh, causal, window, q_offset = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q = _randn(rng, (B, Sq, H, dh))
    k = _randn(rng, (B, Sk, Hkv, dh))
    v = _randn(rng, (B, Sk, Hkv, dh))
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=q_offset).numpy()
    assert fa_ops.flash_attention.launches == before   # CPU: plain version
    pallas = jfa_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset, interpret=True)
    ref = jfa_ref.flash_attention_ref(
        jnp.asarray(q).swapaxes(1, 2), jnp.asarray(k).swapaxes(1, 2),
        jnp.asarray(v).swapaxes(1, 2), causal=causal, window=window,
        q_offset=q_offset).swapaxes(1, 2)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


# (B, C, H, Hkv, dh, window, cur range, holes)
DECODE_CASES = {
    "gqa4:2-dh32": (2, 16, 4, 2, 32, None, (0, 15), 0.0),
    "gqa8:1-holes": (3, 24, 8, 1, 32, None, (5, 23), 0.3),
    "gqa16:8-dh128-wrapped-window": (2, 20, 16, 8, 128, 20, (30, 90), 0.0),
    "wrapped-ring-no-window": (2, 12, 4, 2, 32, None, (20, 40), 0.0),
    "wrapped-window-holes": (3, 16, 8, 1, 32, 16, (16, 64), 0.2),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_matches_jax(case):
    B, C, H, Hkv, dh, window, (lo, hi), holes = DECODE_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    q = _randn(rng, (B, H, dh))
    k = _randn(rng, (B, C, Hkv, dh))
    v = _randn(rng, (B, C, Hkv, dh))
    cur = rng.integers(lo, hi + 1, size=B).astype(np.int32)
    pos = _ring_pos(rng, cur, C, holes)
    # every row keeps its newest slot, so no row is fully masked
    pos[np.arange(B), cur % C] = cur
    before = da_ops.decode_attention.launches
    got = da_ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.from_numpy(cur), window=window).numpy()
    assert da_ops.decode_attention.launches == before
    args = tuple(jnp.asarray(a) for a in (q, k, v, pos, cur))
    pallas = jda_ops.decode_attention(*args, window=window, interpret=True)
    ref = jda_ref.decode_attention_ref(*args, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel launchers take CUDA tensors only; a CPU tensor reaches the
    plain version through ``ops``, never the kernel."""
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="cpu"):
        fa_kernel.flash_attention_kernel(q, kv, kv)
    pos = torch.zeros(1, 8, dtype=torch.int32)
    cur = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="cpu"):
        da_kernel.decode_attention_kernel(q[:, 0], kv, kv, pos, cur)


_C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p", "int": "c_int"}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_c_entry(name):
    """Each ctypes argtypes list matches its ``extern "C"`` entry point in
    ``csrc`` argument for argument (a mismatch truncates pointers)."""
    src = "".join(p.read_text() for p in Path(_build.CSRC).glob("*.cu"))
    m = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S)
    assert m, f"{name} not found in csrc"
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    want = [_C_TYPES[p] for p in params]
    got = [t.__name__ for t in _build.SIGNATURES[name]]
    assert got == want
