"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode and its plain references.

Inputs are made with numpy from a seed and handed to both packages, at f32.
Tolerance 1e-5 abs/rel for the dense kernels: the math is the same, only
the summation order differs.  The paged and prefix cases use the reference
tests' 2e-4 (``tests/test_kernels.py``): the Pallas kernels there run their
online softmax in interpret mode, block by block.  The CUDA kernels
themselves run only on a GPU (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro.kernels.decode_attention import ops as jda_ops
from repro.kernels.decode_attention import ref as jda_ref
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.matmul import ops as jmm_ops
from repro.kernels.matmul import ref as jmm_ref
from repro.kernels.paged_attention import ops as jpa_ops
from repro.kernels.paged_attention import ref as jpa_ref
from repro.kernels.prefix_attention import ops as jpfx_ops
from repro.kernels.prefix_attention import ref as jpfx_ref
from repro.kernels.rmsnorm import ops as jrms_ops
from repro.kernels.rmsnorm import ref as jrms_ref
from repro.models.attention import chunked_flash_attention as jchunked
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.matmul import kernel as mm_kernel
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.prefix_attention import kernel as pfx_kernel
from repro_torch.kernels.prefix_attention import ops as pfx_ops
from repro_torch.kernels.prefix_attention import ref as pfx_ref
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.attention import chunked_flash_attention

TOL = dict(rtol=1e-5, atol=1e-5)
PAGED_TOL = dict(rtol=2e-4, atol=2e-4)


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


# ---------------------------------------------------------------------------
# paged decode attention: in-kernel page walk vs the materialised gather
# ---------------------------------------------------------------------------


def _pools(rng, P, ps, Hkv, dh):
    """Random pools with the trash page poisoned to 1e4, so an unmapped-page
    or beyond-cur_pos leak is a loud mismatch, not an average."""
    kp = _randn(rng, (P + 1, ps, Hkv, dh))
    vp = _randn(rng, (P + 1, ps, Hkv, dh))
    kp[P] = 1e4
    vp[P] = 1e4
    return kp, vp


def _paged_all(q, kp, vp, table, cur):
    """(port, Pallas interpret, JAX ref) on the same numpy inputs."""
    before = pa_ops.paged_decode_attention.launches
    got = pa_ops.paged_decode_attention(*(torch.from_numpy(a) for a in
                                          (q, kp, vp, table, cur))).numpy()
    assert pa_ops.paged_decode_attention.launches == before   # CPU: plain
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, table, cur))
    pallas = jpa_ops.paged_decode_attention(*args, interpret=True)
    ref = jpa_ref.paged_decode_attention_ref(*args)
    return got, np.asarray(pallas), np.asarray(ref)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 1), (8, 8)])
def test_paged_decode_attention_matches_jax(H, Hkv):
    """Unmapped holes mid-table; cur_pos mid-page, at a page boundary - 1
    and at full capacity (tests/test_kernels.py:163)."""
    B, dh, P, ps = 3, 32, 10, 8
    rng = np.random.default_rng(H * 10 + Hkv)
    q = _randn(rng, (B, H, dh))
    kp, vp = _pools(rng, P, ps, Hkv, dh)
    table = np.asarray([[0, 3, -1, -1], [5, -1, 7, -1], [2, 4, 6, 8]], np.int32)
    cur = np.asarray([9, 23, 31], np.int32)
    got, pallas, ref = _paged_all(q, kp, vp, table, cur)
    np.testing.assert_allclose(got, pallas, **PAGED_TOL)
    np.testing.assert_allclose(got, ref, **PAGED_TOL)


def test_paged_decode_attention_page_boundary_sweep():
    """cur_pos over every position of a 2-page window: the fused
    ``pos <= cur_pos`` mask flips exactly one key per step."""
    B, H, Hkv, dh, P, ps = 1, 4, 2, 32, 4, 8
    rng = np.random.default_rng(7)
    kp, vp = _pools(rng, P, ps, Hkv, dh)
    table = np.asarray([[1, 2]], np.int32)
    for cur in range(2 * ps):
        q = _randn(rng, (B, H, dh))
        got, pallas, ref = _paged_all(q, kp, vp, table,
                                      np.asarray([cur], np.int32))
        np.testing.assert_allclose(got, pallas, **PAGED_TOL, err_msg=f"cur={cur}")
        np.testing.assert_allclose(got, ref, **PAGED_TOL, err_msg=f"cur={cur}")


def test_paged_decode_attention_fully_unmapped_slot_is_finite():
    """An inactive slot (every page -1) gives a finite output — the uniform
    average over the gathered trash rows, as in the reference."""
    B, H, Hkv, dh, P, ps = 2, 4, 2, 32, 4, 8
    rng = np.random.default_rng(11)
    q = _randn(rng, (B, H, dh))
    kp, vp = _pools(rng, P, ps, Hkv, dh)
    table = np.full((B, 2), -1, np.int32)
    cur = np.zeros((B,), np.int32)
    got, pallas, ref = _paged_all(q, kp, vp, table, cur)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, rtol=2e-4)
    np.testing.assert_allclose(got, ref, rtol=2e-4)


# ---------------------------------------------------------------------------
# paged decode: the table's pages split across blocks and merged
# ---------------------------------------------------------------------------

# (B, H, Hkv, dh, ps, table rows, cur per row, pages_per_split or None for
# the planner's split of the main path's shape)
DECODE_PAGED_SPLIT_CASES = {
    # pages of 4: a 32-row tile spans 8 pages; holes mid-table
    "page-size-4": (3, 4, 2, 32, 4, [[0, 3, 9, -1, 11, 12, -1, -1],
                                     [5, -1, 7, 1, 2, 4, 6, 8],
                                     [10, 13, -1, -1, -1, -1, -1, -1]],
                    [17, 30, 5], 3),
    # pages of 8: four pages a tile, splits of 2
    "page-size-8": (2, 4, 2, 32, 8, [[2, 0, 5, 1, 3, -1], [4, 6, 7, -1, 8, 9]],
                    [33, 47], 2),
    # mid-table holes, cur mid-page, at a page's end and at the table's end
    "holes": (3, 8, 2, 32, 8, [[0, 3, -1, -1], [5, -1, 7, -1], [2, 4, 6, 8]],
              [9, 23, 31], 1),
    # every entry -1: the slot averages the (poisoned) trash page
    "fully-unmapped-slot": (2, 4, 2, 32, 8, [[-1, -1, -1], [1, 2, -1]],
                            [0, 9], 1),
    # the second split's pages are all holes: it sees no key and weighs 0
    "split-all-skipped": (2, 4, 2, 32, 8, [[1, 2, -1, -1, 5, 6],
                                           [3, 4, -1, -1, -1, -1]],
                          [47, 12], 2),
    # six one-page splits over a table with two mapped pages
    "more-splits-than-mapped-pages": (2, 4, 2, 32, 8,
                                      [[4, 7, -1, -1, -1, -1],
                                       [9, -1, -1, -1, -1, -1]], [10, 3], 1),
    # 7 pages in splits of 3: the last split holds one page, cur inside it
    "ragged-last-split": (2, 4, 2, 32, 8, [[0, 1, 2, 3, 4, 5, 6],
                                           [7, 8, 9, 10, 11, 12, 13]],
                          [50, 44], 3),
    # GQA 16:1 at dh 64 and 128
    "gqa16:1-dh64": (2, 16, 1, 64, 8, [[0, 1, 2, -1], [3, 5, 4, 6]],
                     [17, 29], 2),
    "gqa16:1-dh128": (2, 16, 1, 128, 16, [[0, -1, 2], [3, 5, 4]],
                      [40, 33], 1),
    # the planner's split of the paged path's 21 pages of 16
    "planner-main-path": (2, 4, 2, 32, 16,
                          [list(range(21)), list(range(21, 38)) + [-1] * 4],
                          [321, 260], None),
}


def _decode_split_all(table, cur, B, H, Hkv, dh, ps, pps, seed):
    """(split ref, one-pass port ref, JAX ref, Pallas interpret) of the
    paged decode on numpy inputs made from ``seed``."""
    table = np.asarray(table, np.int32)
    cur = np.asarray(cur, np.int32)
    n_split = -(-table.shape[1] // pps)
    P = int(table.max()) + 1
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, H, dh))
    kp, vp = _pools(rng, P, ps, Hkv, dh)
    targs = tuple(torch.from_numpy(a) for a in (q, kp, vp, table, cur))
    got = pa_ref.paged_decode_attention_split_ref(
        *targs, n_split=n_split, pages_per_split=pps).numpy()
    one_pass = pa_ref.paged_decode_attention_ref(*targs).numpy()
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, table, cur))
    jref = np.asarray(jpa_ref.paged_decode_attention_ref(*args))
    pallas = np.asarray(jpa_ops.paged_decode_attention(*args, interpret=True))
    return got, one_pass, jref, pallas


@pytest.mark.parametrize("case", list(DECODE_PAGED_SPLIT_CASES))
def test_paged_decode_split_merge_matches_the_references(case):
    """Partials per split of the table's entries (only valid keys when the
    slot attends to some position, every key at -1e30 otherwise), then the
    merge, equal the one-pass softmax of both packages' references and the
    Pallas kernel in interpret mode: a split that saw no key weighs 0, and
    a slot with no valid key averages V over every gathered row.
    Tolerance 2e-4 (the reference kernel tests'), relative where the
    poisoned trash page (1e4) is averaged."""
    B, H, Hkv, dh, ps, table, cur, pps = DECODE_PAGED_SPLIT_CASES[case]
    if pps is None:
        _, pps = pa_kernel.plan_page_splits(8, 8, len(table[0]))
    t = np.asarray(table)
    mapped = t >= 0
    first = np.arange(t.shape[1])[None, :] * ps
    attended = mapped & (first <= np.asarray(cur)[:, None])
    if case == "fully-unmapped-slot":
        assert not attended.any(axis=1).all()
    if case == "split-all-skipped":        # split 1 of slot 0: no key
        assert attended[0].any() and not attended[0, pps:2 * pps].any()
    if case == "more-splits-than-mapped-pages":
        assert t.shape[1] // pps > mapped.sum(axis=1).max()
    if case == "ragged-last-split":
        assert t.shape[1] % pps and attended[:, -1].any()
    got, one_pass, jref, pallas = _decode_split_all(
        table, cur, B, H, Hkv, dh, ps, pps, seed=len(case) + 500)
    np.testing.assert_allclose(got, one_pass, **PAGED_TOL)
    np.testing.assert_allclose(got, jref, **PAGED_TOL)
    np.testing.assert_allclose(got, pallas, **PAGED_TOL)


@pytest.mark.parametrize("cur", [6, 7, 8, 9, 15, 16, 17, 31, 32, 33, 39])
def test_paged_decode_split_merge_cur_pos_sweep(cur):
    """cur_pos swept across page (8) and split (16) boundaries: each step
    moves one key into the slot, and from 16 on into the next split."""
    got, one_pass, jref, pallas = _decode_split_all(
        [[2, 0, 5, 1, 3]], [cur], 1, 4, 2, 32, 8, 2, seed=cur + 600)
    np.testing.assert_allclose(got, one_pass, **PAGED_TOL)
    np.testing.assert_allclose(got, jref, **PAGED_TOL)
    np.testing.assert_allclose(got, pallas, **PAGED_TOL)


def test_paged_decode_split_plan_fills_the_card_on_the_paged_path():
    """qwen3-0.6b paged serving: B=8 slots, 8 kv heads, 21 pages of 16 a
    slot -> 6 splits of 4 pages, 384 blocks of the split pass (>= 2 x
    132), each split two 32-row tiles; every split holds a table entry."""
    n_split, pps = pa_kernel.plan_page_splits(8, 8, 21)
    assert n_split * 8 * 8 >= pa_kernel.MIN_BLOCKS == 264
    assert (n_split, pps) == (6, 4)
    assert (n_split - 1) * pps < 21 <= n_split * pps


# ---------------------------------------------------------------------------
# prefix-context flash attention: two phases vs the concat oracle
# ---------------------------------------------------------------------------


def _prefix_inputs(rng, B, Sq, Lp, Sk, H, Hkv, dh):
    return (_randn(rng, (B, Sq, H, dh)), _randn(rng, (B, Lp, Hkv, dh)),
            _randn(rng, (B, Lp, Hkv, dh)), _randn(rng, (B, Sk, Hkv, dh)),
            _randn(rng, (B, Sk, Hkv, dh)))


def _prefix_port(arrays, q_offset=0):
    before = pfx_ops.prefix_flash_attention.launches
    out = pfx_ops.prefix_flash_attention(
        *(torch.from_numpy(a) for a in arrays), q_offset=q_offset).numpy()
    assert pfx_ops.prefix_flash_attention.launches == before   # CPU: plain
    return out


@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 1), (8, 8)])
@pytest.mark.parametrize("Lp,Sq,qo", [(28, 4, 0), (10, 7, 3), (33, 9, 0)])
def test_prefix_attention_matches_jax(H, Hkv, Lp, Sq, qo):
    """Ragged Lp and Sq, q_offset > 0 (tests/test_kernels.py:226)."""
    B, dh, Sk = 2, 32, Sq + qo
    rng = np.random.default_rng(Lp * 100 + Sq * 10 + H + Hkv)
    arrays = _prefix_inputs(rng, B, Sq, Lp, Sk, H, Hkv, dh)
    got = _prefix_port(arrays, q_offset=qo)
    jargs = tuple(jnp.asarray(a) for a in arrays)
    pallas = jpfx_ops.prefix_flash_attention(*jargs, q_offset=qo, block_q=8,
                                             block_k=16, interpret=True)
    ref = jpfx_ref.prefix_flash_attention_ref(*jargs, q_offset=qo)
    np.testing.assert_allclose(got, np.asarray(pallas), **PAGED_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **PAGED_TOL)


def test_prefix_attention_multi_block_both_phases():
    """Prefix and suffix each span several of the reference's k blocks and
    q spans several q blocks."""
    B, H, Hkv, dh, Lp, Sq = 1, 4, 2, 32, 21, 18
    rng = np.random.default_rng(21)
    arrays = _prefix_inputs(rng, B, Sq, Lp, Sq, H, Hkv, dh)
    got = _prefix_port(arrays)
    jargs = tuple(jnp.asarray(a) for a in arrays)
    pallas = jpfx_ops.prefix_flash_attention(*jargs, block_q=4, block_k=4,
                                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **PAGED_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jpfx_ref.prefix_flash_attention_ref(*jargs)),
        **PAGED_TOL)


def test_prefix_attention_matches_the_concat_paths():
    """The plain version equals chunked attention over the concatenated
    K/V with the causal offset Lp, in both packages."""
    B, H, Hkv, dh, Lp, Sq = 2, 4, 2, 32, 16, 8
    rng = np.random.default_rng(31)
    q, pk, pv, k, v = _prefix_inputs(rng, B, Sq, Lp, Sq, H, Hkv, dh)
    got = _prefix_port((q, pk, pv, k, v))
    kc, vc = np.concatenate([pk, k], 1), np.concatenate([pv, v], 1)
    want = chunked_flash_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        causal=True, q_offset=Lp).numpy()
    jwant = jchunked(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                     causal=True, q_offset=Lp)
    np.testing.assert_allclose(got, want, **PAGED_TOL)
    np.testing.assert_allclose(got, np.asarray(jwant), **PAGED_TOL)


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
    pool = torch.zeros(3, 4, 2, 64)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cpu"):
        pa_kernel.paged_decode_attention_kernel(
            torch.zeros(1, 4, 64), pool, pool, table, cur)
    with pytest.raises(ValueError, match="cpu"):
        pa_kernel.paged_verify_attention_kernel(
            torch.zeros(1, 3, 4, 64), pool, pool, table, cur)
    with pytest.raises(ValueError, match="cpu"):
        pfx_kernel.prefix_flash_attention_kernel(q, kv, kv, kv, kv)
    with pytest.raises(ValueError, match="cpu"):
        rms_kernel.rmsnorm_kernel(torch.zeros(2, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="cpu"):
        mm_kernel.matmul_kernel(torch.zeros(2, 8), torch.zeros(8, 3))


_C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p", "int": "c_int",
            "float": "c_float"}


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


@pytest.mark.parametrize("src", sorted(p.name for p in Path(_build.CSRC).glob("*.cu")))
def test_kernel_sources_include_only_local_headers_that_exist(src):
    """Each ``#include "..."`` of a kernel source names a header in
    ``csrc`` (the build passes no include path), and the shared attention
    helpers are defined once, in ``attn_common.cuh``."""
    text = (Path(_build.CSRC) / src).read_text()
    for name in re.findall(r'#include "([^"]+)"', text):
        assert (Path(_build.CSRC) / name).is_file(), name
    assert '#include "attn_common.cuh"' in text
    for helper in ("to_f32", "from_f32", "warp_sum", "max16", "sum16"):
        assert not re.search(rf"float {helper}\(|\b{helper}<[^>]*>\(float",
                             text), f"{src} redefines {helper}"


def test_build_stamp_covers_headers(tmp_path, monkeypatch):
    """Editing a header in ``csrc`` rebuilds the library, as editing a
    source does."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._stamp(_build._sources())
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._stamp(_build._sources()) != before
    assert _build._sources() == [tmp_path / "a.cu"]


def test_build_stamp_covers_every_included_header():
    """Every header a kernel source or header includes is a ``*.cuh`` in
    ``csrc``, which the stamp hashes: the tensor-core tile header too."""
    csrc = Path(_build.CSRC)
    included = set()
    for path in [*csrc.glob("*.cu"), *csrc.glob("*.cuh")]:
        included |= set(re.findall(r'#include "([^"]+)"', path.read_text()))
    assert "attn_mma.cuh" in included
    assert included <= {p.name for p in csrc.glob("*.cuh")}


# ---------------------------------------------------------------------------
# rmsnorm and matmul: the plain versions against the reference's Pallas
# kernels in interpret mode and its plain references
# ---------------------------------------------------------------------------

BF16_TOL = dict(rtol=2e-2, atol=2e-2)       # tests/test_kernels.py's tol()
F32_MM_TOL = dict(rtol=5e-4, atol=5e-4)


def _bf16_pair(a):
    """The same bf16 values for both packages (numpy holds the f32 ones)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


RMS_SHAPES = [(4, 128, 256), (2, 64, 1024), (1, 8, 512), (7, 5120), (3, 130)]


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bf16 x f32 scale"])
def test_rmsnorm_matches_jax(shape, dtype):
    """``ops.rmsnorm`` on the CPU (the plain version) against JAX's Pallas
    kernel in interpret mode and its ``ref.rmsnorm_ref``: f32 max abs 1e-5,
    bf16 within the reference test's 2e-2 (both round one f32 value to
    bf16; their sums of squares differ in order)."""
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    x = _randn(rng, shape)
    s = _randn(rng, (shape[-1],))
    if dtype == "float32":
        tx, jx, ts, js = torch.from_numpy(x), jnp.asarray(x), \
            torch.from_numpy(s), jnp.asarray(s)
    else:
        tx, jx = _bf16_pair(x)
        ts, js = (_bf16_pair(s) if dtype == "bfloat16"
                  else (torch.from_numpy(s), jnp.asarray(s)))
    got = rms_ops.rmsnorm(tx, ts)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    for want in (jrms_ops.rmsnorm(jx, js, interpret=True),
                 jrms_ref.rmsnorm_ref(jx, js)):
        if dtype == "float32":
            assert np.abs(_f32(got) - _f32(want)).max() <= 1e-5
        else:
            np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)


MM_CASES = {
    "128x128x128": ((128, 128), (128, 128)),
    "256x512x384": ((256, 512), (512, 384)),
    "512x256x128": ((512, 256), (256, 128)),
    "64x1024x256": ((64, 1024), (1024, 256)),
    "ragged 100x300x72": ((100, 300), (300, 72)),
    "leading dims (2, 50, 300)": ((2, 50, 300), (300, 72)),
}


@pytest.mark.parametrize("case", list(MM_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bf16 -> f32"])
def test_matmul_matches_jax(case, dtype):
    """``ops.matmul`` on the CPU against JAX's Pallas kernel in interpret
    mode (blocks of 128, ragged shapes padded there) and its
    ``ref.matmul_ref``, with the reference test's tolerances: f32 5e-4,
    bf16 2e-2."""
    sa, sb = MM_CASES[case]
    rng = np.random.default_rng(sa[-1] + sb[-1])
    a, b = _randn(rng, sa), _randn(rng, sb)
    out_dtype = None
    if dtype == "float32":
        ta, ja, tb, jb = torch.from_numpy(a), jnp.asarray(a), \
            torch.from_numpy(b), jnp.asarray(b)
    else:
        (ta, ja), (tb, jb) = _bf16_pair(a), _bf16_pair(b)
    if dtype == "bf16 -> f32":
        out_dtype = (torch.float32, jnp.float32)
    got = mm_ops.matmul(ta, tb, out_dtype=out_dtype and out_dtype[0])
    want_dtype = out_dtype[0] if out_dtype else ta.dtype
    assert got.shape == (*sa[:-1], sb[-1]) and got.dtype == want_dtype
    jout = out_dtype and out_dtype[1]
    wants = [jmm_ops.matmul(ja, jb, block_m=128, block_n=128, block_k=128,
                            out_dtype=jout, interpret=True)]
    if len(sa) == 2:
        wants.append(jmm_ref.matmul_ref(ja, jb, out_dtype=jout))
    tol = F32_MM_TOL if want_dtype == torch.float32 else BF16_TOL
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_rmsnorm_and_matmul_wrappers_count_only_card_launches():
    """On the CPU the wrappers take the plain versions and leave their
    launch counters alone."""
    before = (rms_ops.rmsnorm.launches, mm_ops.matmul.launches)
    rms_ops.rmsnorm(torch.ones(2, 8), torch.ones(8))
    mm_ops.matmul(torch.ones(2, 8), torch.ones(8, 3))
    assert (rms_ops.rmsnorm.launches, mm_ops.matmul.launches) == before


# (d, itemsize, first row's address, route)
RMS_ROUTE_CASES = {
    "admission (2048, 1024) bf16": (1024, 2, 0, "registers"),
    "admission f32": (1024, 4, 4096, "registers"),
    "narrow d=8 bf16 (one vector a row)": (8, 2, 256, "registers"),
    "q/k norm d=128 bf16": (128, 2, 512, "registers"),
    "wide d=4096 bf16 (a block a row)": (4096, 2, 0, "registers"),
    "widest d=12288 f32": (12288, 4, 0, "registers"),
    "view one bf16 element off the boundary": (256, 2, 2, "two_pass"),
    "view one f32 element off the boundary": (1024, 4, 4, "two_pass"),
    "d=130 bf16: 260-byte rows": (130, 2, 0, "two_pass"),
    "d=5 f32: 20-byte rows": (5, 4, 0, "two_pass"),
    "d=12 bf16: 24-byte rows": (12, 2, 0, "two_pass"),
    "wide d=4100 bf16: 8,200-byte rows": (4100, 2, 0, "two_pass"),
}


@pytest.mark.parametrize("case", list(RMS_ROUTE_CASES))
def test_rmsnorm_route_planner(case):
    """``kernel.rmsnorm_route`` is a pure function of (d, itemsize,
    address): rows that start on a 16-byte boundary and span a multiple of
    16 bytes take the register route, every other row the two-pass
    kernel.  It launches nothing."""
    d, itemsize, addr, want = RMS_ROUTE_CASES[case]
    before = dict(rms_ops.rmsnorm.route_launches)
    assert rms_kernel.rmsnorm_route(d, itemsize, addr) == want
    assert rms_ops.rmsnorm.route_launches == before


def test_rmsnorm_route_of_tensors_and_counters():
    """``kernel.route_of`` reads the planner's inputs off a tensor (CPU
    tensors here: the planner needs no card); the per-route counters sit
    beside ``rmsnorm.launches`` and count nothing on the CPU."""
    assert set(rms_ops.rmsnorm.route_launches) == set(rms_kernel.ROUTES)
    base = torch.zeros(1 + 64 * 256, dtype=torch.bfloat16)
    if base.data_ptr() % 16 == 0:
        assert rms_kernel.route_of(base[:64 * 256].view(64, 256)) == "registers"
        assert rms_kernel.route_of(base[1:].view(64, 256)) == "two_pass"
    assert rms_kernel.route_of(torch.zeros(3, 130)) == "two_pass"
    before = dict(rms_ops.rmsnorm.route_launches)
    rms_ops.rmsnorm(torch.ones(4, 1024, dtype=torch.bfloat16),
                    torch.ones(1024, dtype=torch.bfloat16))
    assert rms_ops.rmsnorm.route_launches == before


def test_rmsnorm_and_matmul_kernels_refuse_what_they_do_not_take():
    """The launchers' checks run before any build: dtypes, shapes and the
    widest row (``MAX_D``) are refused with a ValueError."""
    meta = torch.device("meta")

    def fake_cuda(t):
        # a tensor the checks take for a card tensor: only .device differs
        class T:
            def __init__(self, t):
                self._t = t

            def __getattr__(self, k):
                return getattr(self._t, k)

            @property
            def device(self):
                return torch.device("cuda", 0)

        return T(t)

    x = fake_cuda(torch.zeros(2, 8, device=meta))
    with pytest.raises(ValueError, match="dtype"):
        rms_kernel.check_inputs(fake_cuda(torch.zeros(2, 8, dtype=torch.float16,
                                                      device=meta)),
                                fake_cuda(torch.zeros(8, device=meta)))
    with pytest.raises(ValueError, match="scale"):
        rms_kernel.check_inputs(x, fake_cuda(torch.zeros(7, device=meta)))
    wide = rms_kernel.MAX_D + 1
    with pytest.raises(ValueError, match="d="):
        rms_kernel.check_inputs(fake_cuda(torch.zeros(1, wide, device=meta)),
                                fake_cuda(torch.zeros(wide, device=meta)))
    rms_kernel.check_inputs(x, fake_cuda(torch.zeros(8, dtype=torch.bfloat16,
                                                     device=meta)))
    b = fake_cuda(torch.zeros(8, 3, device=meta))
    with pytest.raises(ValueError, match="dtypes"):
        mm_kernel.check_inputs(x, fake_cuda(torch.zeros(8, 3,
                                                        dtype=torch.bfloat16,
                                                        device=meta)),
                               torch.float32)
    with pytest.raises(ValueError, match="shapes"):
        mm_kernel.check_inputs(x, fake_cuda(torch.zeros(7, 3, device=meta)),
                               torch.float32)
    with pytest.raises(ValueError, match="out_dtype"):
        mm_kernel.check_inputs(x, b, torch.float16)
    mm_kernel.check_inputs(x, b, torch.bfloat16)


# ---------------------------------------------------------------------------
# the CUDA kernels' arithmetic in plain torch: dense decode split across the
# cache and merged, and the bf16 flash route's P rounded before P V
# ---------------------------------------------------------------------------

# (B, C, H, Hkv, dh, window, cur per row, split_len (None: the planner's),
#  pos edit)
SPLIT_CASES = {
    "C-not-a-multiple": (3, 100, 8, 2, 32, None, [120, 150, 99], 32, None),
    "C-below-one-split": (2, 20, 4, 2, 32, None, [7, 19], 32, None),
    "masked-split": (2, 96, 4, 2, 32, None, [95, 80], 32, "empty-split-1"),
    "no-valid-slot": (3, 70, 4, 2, 32, None, [100, 69, 30], 32, "empty-row-0"),
    "window-wraps-split": (4, 48, 8, 2, 32, 40, [70, 90, 100, 119], 32, None),
    "gqa16:1": (2, 70, 16, 1, 64, None, [69, 40], 32, None),
    "planner-main-path-C": (2, 322, 4, 2, 32, None, [300, 257], None, None),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_split_merge_matches_the_references(case):
    """Partials per split of the cache, then the merge, equal the one-pass
    softmax: a split whose slots are all masked weighs 0, and a row with no
    valid slot averages V over the C slots as the plain references do (the
    Pallas kernel averages over its padded block there, ROADMAP.md Queue 3,
    so that row is held against the plain references only)."""
    B, C, H, Hkv, dh, window, cur, split_len, edit = SPLIT_CASES[case]
    if split_len is None:
        _, split_len = da_kernel.plan_splits(8, C, 8)
    rng = np.random.default_rng(len(case) + 300)
    q = _randn(rng, (B, H, dh))
    k = _randn(rng, (B, C, Hkv, dh))
    v = _randn(rng, (B, C, Hkv, dh))
    cur = np.asarray(cur, np.int32)
    pos = _ring_pos(rng, cur, C)
    if edit == "empty-split-1":
        pos[:, split_len:2 * split_len] = -1
    if edit == "empty-row-0":
        pos[0] = -1
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window is not None:
        valid &= pos > cur[:, None] - window
        # the window's ring wraps past slot 0 and crosses a split boundary
        assert (valid[:, 0] & valid[:, -1] & valid[:, split_len - 1]
                & valid[:, split_len]).any()
    if edit == "empty-split-1":
        assert valid.any(axis=1).all()
        assert not valid[:, split_len:2 * split_len].any()
    targs = tuple(torch.from_numpy(a) for a in (q, k, v, pos, cur))
    got = da_ref.decode_attention_split_ref(*targs, split_len=split_len,
                                            window=window).numpy()
    one_pass = da_ref.decode_attention_ref(*targs, window=window).numpy()
    args = tuple(jnp.asarray(a) for a in (q, k, v, pos, cur))
    jref = np.asarray(jda_ref.decode_attention_ref(*args, window=window))
    np.testing.assert_allclose(got, one_pass, **TOL)
    np.testing.assert_allclose(got, jref, **TOL)
    rows = valid.any(axis=1)
    if edit == "empty-row-0":
        assert not rows[0]
        np.testing.assert_allclose(got[0], v[0].mean(axis=0).repeat(H // Hkv, 0),
                                   **TOL)
    pallas = np.asarray(jda_ops.decode_attention(*args, window=window,
                                                 interpret=True))
    np.testing.assert_allclose(got[rows], pallas[rows], **TOL)


@pytest.mark.parametrize("B,C,Hkv", [
    (8, 322, 8), (8, 1088, 8), (1, 4096, 8), (4, 20, 1), (1, 33, 1),
    (32, 64, 16), (2, 100_000, 1), (64, 322, 8), (1, 1, 1),
])
def test_decode_split_plan_gives_every_split_a_slot(B, C, Hkv):
    n_split, split_len = da_kernel.plan_splits(B, C, Hkv)
    assert split_len % da_kernel.SPLIT_TILE == 0 and split_len > 0
    assert (n_split - 1) * split_len < C <= n_split * split_len
    # as many blocks as MIN_BLOCKS asks where the cache has the slots
    blocks = n_split * Hkv * B
    assert (blocks >= da_kernel.MIN_BLOCKS
            or split_len == da_kernel.SPLIT_TILE)


def test_decode_split_plan_fills_the_card_on_the_main_path():
    """qwen3-0.6b dense serving: B=8 slots, C=322, 8 kv heads -> at least
    2 x 132 blocks in the split pass."""
    n_split, split_len = da_kernel.plan_splits(8, 322, 8)
    assert n_split * 8 * 8 >= 264
    assert (n_split, split_len) == (6, 64)


@pytest.mark.parametrize("window,q_offset", [(None, 0), (64, 0), (None, 32)])
def test_flash_bf16_p_rounding_stays_within_bf16_tol(window, q_offset):
    """The bf16 CUDA route rounds P to bf16 before P V; in plain torch on
    bf16 inputs at the serving prefill shape cut to 2 heads (B=8, S=256,
    dh=128) that stays within the bf16 tolerance of the f32-P reference."""
    B, S, H, Hkv, dh = 8, 256, 2, 1, 128
    rng = np.random.default_rng(7 + (window or 0) + q_offset)
    q, k, v = (torch.from_numpy(_randn(rng, shape)).to(torch.bfloat16)
               for shape in ((B, H, S, dh), (B, Hkv, S + q_offset, dh),
                             (B, Hkv, S + q_offset, dh)))
    got = fa_ref.flash_attention_mma_ref(q, k, v, window=window,
                                         q_offset=q_offset)
    want = fa_ref.flash_attention_ref(q, k, v, window=window,
                                      q_offset=q_offset)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)
    # and the rounding is really there: in f32 the two differ
    assert (got.float() - want.float()).abs().max().item() > 0


# ---------------------------------------------------------------------------
# the verify kernel's pages split across blocks and merged, and the bf16
# routes of the verify and prefix kernels (P rounded before P V)
# ---------------------------------------------------------------------------

# (B, W, H, Hkv, dh, ps, table rows, cur per row, pages_per_split)
VERIFY_SPLIT_CASES = {
    # mid-table holes; windows across page and split boundaries, one at
    # the table's end
    "holes": (3, 4, 4, 2, 32, 8, [[0, 3, 9, -1], [5, -1, 7, -1],
                                  [2, 4, 6, 8]], [6, 14, 28], 2),
    # every entry -1: every row averages the trash page
    "fully-unmapped-slot": (2, 2, 4, 2, 32, 8, [[-1, -1, -1], [1, 2, -1]],
                            [0, 9], 1),
    # row 0 has no key (its pages unmapped), later rows of the window do:
    # every page is walked and row 0 averages all gathered rows
    "row0-without-keys": (2, 4, 4, 2, 32, 16, [[-1, 3, -1, -1],
                                               [-1, 6, -1, -1]], [14, 15], 2),
    # the window ends before the second split's pages: all skipped
    "split-all-skipped": (2, 4, 4, 2, 32, 8, [[1, 2, 5, 6, 7, 8],
                                              [3, 4, -1, -1, -1, -1]],
                          [9, 4], 3),
    # six one-page splits over a table with two mapped pages
    "more-splits-than-mapped-pages": (2, 2, 4, 2, 32, 8,
                                      [[4, 7, -1, -1, -1, -1],
                                       [9, -1, -1, -1, -1, -1]], [10, 3], 1),
    # 32 query rows per kv head: GQA 16:1 with W=2, and W=8 at group 4
    "gqa16:1-W2": (2, 2, 16, 1, 32, 8, [[0, 1, 2, -1], [3, 5, 4, 6]],
                   [17, 24], 2),
    "W8-32-rows": (2, 8, 8, 2, 32, 4, [[0, 1, 2, 3, 4, 5, -1, -1],
                                       [6, 7, -1, 8, 9, -1, -1, -1]],
                   [13, 7], 3),
    # the planner's split of the speculative path's 21 pages of 16
    "planner-main-path": (2, 4, 4, 2, 32, 16,
                          [list(range(21)), list(range(21, 38)) + [-1] * 4],
                          [300, 260], None),
}


def _verify_split_all(case):
    """(split ref, one-pass port ref, JAX ref, Pallas interpret) of one
    VERIFY_SPLIT_CASES entry, on numpy inputs made from a seed."""
    B, W, H, Hkv, dh, ps, table, cur, pps = VERIFY_SPLIT_CASES[case]
    table = np.asarray(table, np.int32)
    if pps is None:
        _, pps = pa_kernel.plan_page_splits(8, 8, table.shape[1])
    P = int(table.max()) + 1
    rng = np.random.default_rng(len(case) + 400)
    q = _randn(rng, (B, W, H, dh))
    kp, vp = _pools(rng, P, ps, Hkv, dh)
    cur = np.asarray(cur, np.int32)
    targs = tuple(torch.from_numpy(a) for a in (q, kp, vp, table, cur))
    got = pa_ref.paged_verify_attention_split_ref(
        *targs, pages_per_split=pps).numpy()
    one_pass = pa_ref.paged_verify_attention_ref(*targs).numpy()
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, table, cur))
    jref = np.asarray(jpa_ref.paged_verify_attention_ref(*args))
    pallas = np.asarray(jpa_ops.paged_verify_attention(*args, interpret=True))
    return got, one_pass, jref, pallas, (table, cur, ps, W, pps)


@pytest.mark.parametrize("case", list(VERIFY_SPLIT_CASES))
def test_verify_split_merge_matches_the_references(case):
    """Partials per split of the table's pages (pages no row attends
    skipped when row 0 has a key), then the merge, equal the one-pass
    softmax of both packages' references and the Pallas kernel: a split
    whose pages were all skipped weighs 0, and a row with no valid key
    averages V over every gathered row.  Tolerance 2e-4 (the reference
    kernel tests'), relative where the poisoned trash page (1e4) is
    averaged."""
    got, one_pass, jref, pallas, (table, cur, ps, W, pps) = _verify_split_all(case)
    mapped = (table >= 0)
    first = np.arange(table.shape[1])[None, :] * ps
    row0 = (mapped & (first <= cur[:, None])).any(axis=1)
    if case in ("fully-unmapped-slot", "row0-without-keys"):
        assert not row0.all()
    if case == "split-all-skipped":
        last = cur + W - 1
        assert row0.all() and (first[0, pps:2 * pps] > last[0]).all()
    if case == "more-splits-than-mapped-pages":
        assert table.shape[1] // pps > mapped.sum(axis=1).max()
    np.testing.assert_allclose(got, one_pass, **PAGED_TOL)
    np.testing.assert_allclose(got, jref, **PAGED_TOL)
    np.testing.assert_allclose(got, pallas, **PAGED_TOL)


@pytest.mark.parametrize("cur", [12, 13, 14, 15, 16, 17, 29, 30, 31])
def test_verify_split_merge_page_boundary_sweep(cur):
    """cur_pos swept across page and split boundaries (pages of 8, splits
    of 2 pages): each step moves one key into or out of a window row."""
    B, W, H, Hkv, dh, ps, pps = 1, 4, 4, 2, 32, 8, 2
    rng = np.random.default_rng(cur)
    q = _randn(rng, (B, W, H, dh))
    kp, vp = _pools(rng, 6, ps, Hkv, dh)
    table = np.asarray([[2, 0, 5, 1, 3]], np.int32)
    cur_a = np.asarray([cur], np.int32)
    targs = tuple(torch.from_numpy(a) for a in (q, kp, vp, table, cur_a))
    got = pa_ref.paged_verify_attention_split_ref(
        *targs, pages_per_split=pps).numpy()
    args = tuple(jnp.asarray(a) for a in (q, kp, vp, table, cur_a))
    np.testing.assert_allclose(
        got, pa_ref.paged_verify_attention_ref(*targs).numpy(), **PAGED_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jpa_ref.paged_verify_attention_ref(*args)), **PAGED_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jpa_ops.paged_verify_attention(*args, interpret=True)),
        **PAGED_TOL)


@pytest.mark.parametrize("B,Hkv,max_pages", [
    (8, 8, 21), (8, 8, 6), (1, 1, 1), (64, 8, 100), (4, 1, 21), (2, 8, 4),
    (1, 1, 1000), (3, 2, 8), (16, 8, 65), (1, 8, 7),
])
def test_verify_split_plan_gives_every_split_a_page(B, Hkv, max_pages):
    n_split, pps = pa_kernel.plan_page_splits(B, Hkv, max_pages)
    assert pps >= 1
    assert (n_split - 1) * pps < max_pages <= n_split * pps
    # as many blocks as MIN_BLOCKS asks where the table has the pages
    assert n_split * Hkv * B >= pa_kernel.MIN_BLOCKS or pps == 1


def test_verify_split_plan_fills_the_card_on_the_spec_path():
    """qwen3-0.6b speculative serving: B=8 slots, 8 kv heads, 21 pages of
    16 a slot -> at least 2 x 132 blocks, each split one staging round (4
    pages) of the bf16 kernel."""
    n_split, pps = pa_kernel.plan_page_splits(8, 8, 21)
    assert n_split * 8 * 8 >= 264
    assert (n_split, pps) == (6, 4)


def test_verify_bf16_p_rounding_stays_within_bf16_tol():
    """The bf16 verify route rounds P to bf16 before P V; on bf16 inputs at
    the speculative path's shape cut to one kv head (B=8, W=4, group 2,
    dh=128, 21 pages of 16, the planner's split) that stays within the bf16
    tolerance of the f32-P references of both packages."""
    B, W, H, Hkv, dh, ps, maxp = 8, 4, 2, 1, 128, 16, 21
    rng = np.random.default_rng(17)
    P = B * maxp
    q, kp, vp = (torch.from_numpy(_randn(rng, shape)).to(torch.bfloat16)
                 for shape in ((B, W, H, dh), (P + 1, ps, Hkv, dh),
                               (P + 1, ps, Hkv, dh)))
    cur = rng.integers(256, 322 - W + 1, size=B).astype(np.int32)
    table = np.arange(P, dtype=np.int32).reshape(B, maxp)
    table[(np.arange(maxp)[None, :] * ps) > (cur[:, None] + W - 1)] = -1
    table[0, 3] = -1                            # a hole
    _, pps = pa_kernel.plan_page_splits(B, 8, maxp)
    targs = (q, kp, vp, torch.from_numpy(table), torch.from_numpy(cur))
    got = pa_ref.paged_verify_attention_split_ref(
        *targs, pages_per_split=pps, round_p=True)
    want = pa_ref.paged_verify_attention_ref(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)
    jwant = jpa_ref.paged_verify_attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in (q, kp, vp)),
        jnp.asarray(table), jnp.asarray(cur))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jwant),
                               **BF16_TOL)
    # and the rounding is really there: in f32 the two differ
    exact = pa_ref.paged_verify_attention_split_ref(*targs, pages_per_split=pps)
    assert (got.float() - exact.float()).abs().max().item() > 0


@pytest.mark.parametrize("Lp,q_offset", [(192, 0), (130, 7), (100, 30), (33, 64)])
def test_prefix_bf16_p_rounding_stays_within_bf16_tol(Lp, q_offset):
    """The bf16 prefix route rounds P to bf16 before P V over 64-key tiles,
    prefix then suffix; on bf16 inputs at the cached-admission shape cut to
    one kv head (B=2, 64 suffix rows, group 2, dh=128), with Lp not a
    multiple of 64 and q_offset > 0 among the cases, that stays within the
    bf16 tolerance of the f32-P references and of the Pallas kernel in
    interpret mode."""
    B, Sq, H, Hkv, dh = 2, 64, 2, 1, 128
    Sk = Sq + q_offset
    rng = np.random.default_rng(Lp + q_offset)
    arrays = _prefix_inputs(rng, B, Sq, Lp, Sk, H, Hkv, dh)
    q, pk, pv, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = pfx_ref.prefix_flash_attention_mma_ref(q, pk, pv, k, v,
                                                 q_offset=q_offset)
    want = pfx_ref.prefix_flash_attention_ref(q, pk, pv, k, v,
                                              q_offset=q_offset)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)
    jargs = tuple(jnp.asarray(t.float().numpy()) for t in (q, pk, pv, k, v))
    pallas = jpfx_ops.prefix_flash_attention(*jargs, q_offset=q_offset,
                                             block_q=64, block_k=64,
                                             interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas),
                               **BF16_TOL)
    # in f32 the emulation without the rounding is the plain version
    exact = pfx_ref.prefix_flash_attention_mma_ref(
        *(t.float() for t in (q, pk, pv, k, v)), q_offset=q_offset)
    assert (got.float() - exact).abs().max().item() > 0


# ---------------------------------------------------------------------------
# the matmul's route planner: which products the wgmma (TMA) route takes
# ---------------------------------------------------------------------------

_BF, _F32 = torch.bfloat16, torch.float32
# (dtype, M, K, N, a strides, b strides, a base, b base, route)
ROUTE_CASES = {
    "admission up bf16": (_BF, 2048, 1024, 3072, (1024, 1), (3072, 1), 0, 0,
                          "wgmma"),
    "admission down bf16": (_BF, 2048, 3072, 1024, (3072, 1), (1024, 1), 512,
                            4096, "wgmma"),
    "decode bf16": (_BF, 8, 1024, 3072, (1024, 1), (3072, 1), 0, 0, "wgmma"),
    "tenant test (64, 128) @ (128, 96)": (_BF, 64, 128, 96, (128, 1), (96, 1),
                                          0, 0, "wgmma"),
    "ragged (100, 300) @ (300, 72): 600-byte rows of a": (
        _BF, 100, 300, 72, (300, 1), (72, 1), 0, 0, "cuda_core"),
    "N = 100: 200-byte rows of b": (_BF, 64, 64, 100, (64, 1), (100, 1), 0, 0,
                                    "cuda_core"),
    "(1, 1) @ (1, 1)": (_BF, 1, 1, 1, (1, 1), (1, 1), 0, 0, "cuda_core"),
    "a off the 16-byte boundary": (_BF, 64, 64, 64, (64, 1), (64, 1), 2, 0,
                                   "cuda_core"),
    "b off the 16-byte boundary": (_BF, 64, 64, 64, (64, 1), (64, 1), 0, 8,
                                   "cuda_core"),
    "b column-major": (_BF, 64, 64, 64, (64, 1), (1, 64), 0, 0, "cuda_core"),
    "f32 admission (no TF32)": (_F32, 2048, 1024, 3072, (1024, 1), (3072, 1),
                                0, 0, "cuda_core"),
    "f32 decode": (_F32, 8, 1024, 3072, (1024, 1), (3072, 1), 0, 0,
                   "cuda_core"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_matmul_route_planner(case):
    """``kernel.matmul_route`` is a pure function of (dtype, shape, strides,
    alignment): bf16 row-major operands with 16-byte aligned bases and rows
    take the wgmma route (TMA's rule), everything else, f32 included, the
    CUDA-core kernel."""
    dtype, M, K, N, sa, sb, pa, pb, want = ROUTE_CASES[case]
    assert mm_kernel.matmul_route(dtype, M, K, N, sa, sb, pa, pb) == want


@pytest.mark.parametrize("case", ["admission up bf16", "decode bf16",
                                  "ragged (100, 300) @ (300, 72): 600-byte "
                                  "rows of a", "f32 decode"])
def test_matmul_route_of_tensors(case):
    """``kernel.route_of`` reads the planner's inputs off two tensors (CPU
    tensors here: the planner needs no card)."""
    dtype, M, K, N, _, _, _, _, want = ROUTE_CASES[case]
    a, b = torch.zeros(M, K, dtype=dtype), torch.zeros(K, N, dtype=dtype)
    if a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0:
        assert mm_kernel.route_of(a, b) == want
    assert mm_kernel.route_of(a, b.t().contiguous().t()) == "cuda_core"


def test_matmul_wrapper_counts_routes_only_on_the_card():
    """The per-route counters sit beside ``matmul.launches`` and, like it,
    count nothing on the CPU."""
    assert set(mm_ops.matmul.route_launches) == set(mm_kernel.ROUTES)
    before = dict(mm_ops.matmul.route_launches)
    mm_ops.matmul(torch.ones(4, 8, dtype=torch.bfloat16),
                  torch.ones(8, 16, dtype=torch.bfloat16))
    assert mm_ops.matmul.route_launches == before


# ---------------------------------------------------------------------------
# chip_smoke.py's planted SSD faults and phase-6 kernel classes stay in step
# with the sources they name
# ---------------------------------------------------------------------------

def _load_chip_smoke():
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CHIP_SMOKE = _load_chip_smoke()


@pytest.mark.parametrize("fault", [f[0] for f in _CHIP_SMOKE.SSD_FAULTS])
def test_ssd_fault_replaces_one_line_of_the_kernel(fault):
    """``chip_smoke.py --ssd-faults`` plants each fault by replacing one
    source line of ``csrc/ssd_scan.cu``: the line must be there exactly
    once, and the fault must change it."""
    name, original, planted = next(f for f in _CHIP_SMOKE.SSD_FAULTS
                                   if f[0] == fault)
    src = (Path(_build.CSRC) / "ssd_scan.cu").read_text()
    assert src.count(original) == 1
    assert planted != original


@pytest.mark.parametrize("kernel,cls", [
    *((k, "ssd_scan") for k in _CHIP_SMOKE.SSD_KERNELS),
    ("ssd_f32_kernel", "ssd_scan"),
    ("mm_wgmma_kernel", "matmul (port)"),
    ("mm_simt_kernel", "matmul (port)"),
    ("paged_decode_split_kernel", "paged_decode_attention"),
    ("paged_decode_merge_kernel", "paged_decode_attention"),
    ("dec_split_kernel", "decode_attention"),
    ("dec_merge_kernel", "decode_attention"),
])
def test_phase6_attributes_the_new_kernels(kernel, cls):
    """Phase 6 names a kernel's class by the first key its (lower-cased,
    demangled) name holds: the SSD passes land in the SSD class and the
    matmul's kernels in the port's matmul class, not cuBLAS's, and the
    paged decode's split and merge kernels in the paged decode class, not
    the dense decode's; each name is a ``__global__`` of the sources."""
    name = f"void (anonymous namespace)::{kernel}<64, 128>(float const*)"
    got = next(c for c, keys in _CHIP_SMOKE._KERNEL_CLASSES
               if any(k in name.lower() for k in keys))
    assert got == cls
    src = "".join(p.read_text() for p in Path(_build.CSRC).glob("*.cu"))
    assert re.search(rf"\b{kernel}\(", src)


@pytest.mark.parametrize("key", [
    key for cls, keys in _CHIP_SMOKE._KERNEL_CLASSES
    if cls != "matmul (cuBLAS)" for key in keys])
def test_phase6_keys_name_kernels_of_the_sources(key):
    """Every key of the port's classes in phase 6 is the name of a
    ``__global__`` of the sources: a key left behind by a kernel that was
    replaced would attribute nothing, or another kernel's time."""
    src = "".join(p.read_text() for p in Path(_build.CSRC).glob("*.cu"))
    assert re.search(rf"__global__ void (__launch_bounds__\([^)]*\) )?"
                     rf"{key}\(", src)
