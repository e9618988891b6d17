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
    (8, 256, 256, 16, 8, 128, 64, 0),
    (2, 100, 300, 16, 8, 128, None, 200),
    (2, 96, 96, 8, 1, 64, None, 0),
    (8, 256, 256, 16, 16, 128, None, 0),       # group 1 (deepseek-moe-16b)
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
    (8, 322, 16, 16, 128, None, 256, 320, 0.2),    # group 1
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,Hkv,dh,window,cur,edit", [
    (2, 100, 16, 8, 128, None, [99, 150], None),          # C not a multiple
    (2, 20, 16, 8, 128, None, [7, 19], None),             # C below one split
    (8, 322, 16, 8, 128, None, [300, 257, 319, 290, 260, 311, 280, 299],
     "empty-split-1"),                                    # a split all masked
    (3, 70, 16, 8, 128, None, [100, 69, 30], "empty-row-0"),   # no valid slot
    (4, 48, 16, 8, 128, 40, [70, 90, 100, 119], None),    # window wraps a split
    (4, 130, 16, 1, 64, None, [129, 60, 200, 5], None),   # GQA 16:1
])
def test_decode_attention_split_cases_match_ref(gen, dtype, B, C, H, Hkv, dh,
                                                window, cur, edit):
    """The split pass and the merge on the splits ``plan_splits`` picks:
    masked splits weigh nothing, and a row with no valid slot averages V
    over the C slots, as ``ref.py`` does."""
    from repro_torch.kernels.decode_attention import kernel, ops, ref

    cur = np.asarray(cur, np.int32)
    c = np.arange(C)[None, :]
    pos = cur[:, None] - ((cur[:, None] - c) % C)
    pos = np.where(pos >= 0, pos, -1).astype(np.int32)
    split_len = kernel.plan_splits(B, C, Hkv)[1]
    if edit == "empty-split-1":
        pos[:, split_len:2 * split_len] = -1
    if edit == "empty-row-0":
        pos[0] = -1
    q = _rand(gen, (B, H, dh), dtype)
    k = _rand(gen, (B, C, Hkv, dh), dtype)
    v = _rand(gen, (B, C, Hkv, dh), dtype)
    pos_t = torch.from_numpy(pos).cuda()
    cur_t = torch.from_numpy(cur).cuda()
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, pos_t, cur_t, window=window)
    want = ref.decode_attention_ref(q, k, v, pos_t, cur_t, window=window)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_decode_attention_kernel_refuses_a_misaligned_cache(gen):
    """The split pass copies K/V rows with 16-byte cp.async: a view that
    starts off the 16-byte boundary is refused, not read wrong."""
    from repro_torch.kernels.decode_attention import kernel

    q = _rand(gen, (2, 4, 32), torch.bfloat16)
    flat = _rand(gen, (2 * 20 * 2 * 32 + 1,), torch.bfloat16)
    k = flat[1:].view(2, 20, 2, 32)
    v = _rand(gen, (2, 20, 2, 32), torch.bfloat16)
    pos = torch.zeros(2, 20, dtype=torch.int32, device="cuda")
    cur = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        kernel.decode_attention_kernel(q, k, v, pos, cur)


def test_prefix_and_verify_kernels_refuse_misaligned_inputs(gen):
    """Both kernels copy rows with 16-byte cp.async: a view that starts off
    the 16-byte boundary is refused, not read wrong."""
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.kernels.prefix_attention import kernel as pfx_kernel

    bf16 = torch.bfloat16
    q = _rand(gen, (1, 8, 4, 32), bf16)
    kv = _rand(gen, (1, 8, 2, 32), bf16)
    shifted = _rand(gen, (8 * 2 * 32 + 1,), bf16)[1:].view(1, 8, 2, 32)
    with pytest.raises(ValueError, match="aligned"):
        pfx_kernel.prefix_flash_attention_kernel(q, shifted, kv, kv, kv)
    pool = _rand(gen, (3, 4, 2, 32), bf16)
    shifted_pool = _rand(gen, (3 * 4 * 2 * 32 + 1,), bf16)[1:].view(3, 4, 2, 32)
    tab = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    cur = torch.zeros((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        pa_kernel.paged_verify_attention_kernel(
            _rand(gen, (1, 2, 4, 32), bf16), shifted_pool, pool, tab, cur)


def test_paged_decode_kernel_refuses_a_misaligned_pool(gen):
    """The split pass copies K/V rows with 16-byte cp.async: a pool view
    that starts off the 16-byte boundary is refused, not read wrong."""
    from repro_torch.kernels.paged_attention import kernel

    bf16 = torch.bfloat16
    pool = _rand(gen, (3, 4, 2, 32), bf16)
    shifted = _rand(gen, (3 * 4 * 2 * 32 + 1,), bf16)[1:].view(3, 4, 2, 32)
    tab = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    cur = torch.zeros((1,), dtype=torch.int32, device="cuda")
    for k, v in ((shifted, pool), (pool, shifted)):
        with pytest.raises(ValueError, match="aligned"):
            kernel.paged_decode_attention_kernel(
                _rand(gen, (1, 4, 32), bf16), k, v, tab, cur)


def _page_table(rng, B, maxp, P, cur, ps, holes):
    """Shuffled distinct pages for logical pages 0..cur // ps of each slot,
    later pages unmapped; ``holes`` unmaps earlier ones at random."""
    perm = rng.permutation(P)
    table = np.full((B, maxp), -1, np.int32)
    for b in range(B):
        last = int(cur[b]) // ps
        table[b, :last + 1] = perm[b * maxp:b * maxp + last + 1]
        table[b, :last][rng.random(last) < holes] = -1
    return table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,dh,ps,maxp,P,lo,hi,holes", [
    (8, 16, 8, 128, 16, 21, 168, 256, 322, 0.0),
    (4, 16, 1, 64, 16, 21, 96, 0, 330, 0.2),
    (3, 8, 2, 128, 8, 6, 30, 0, 48, 0.3),
    (3, 4, 2, 32, 4, 8, 24, 0, 32, 0.2),
    (8, 16, 16, 128, 16, 21, 168, 256, 322, 0.2),    # group 1
])
def test_paged_decode_attention_kernel_matches_ref(gen, dtype, B, H, Hkv, dh,
                                                   ps, maxp, P, lo, hi, holes):
    """Shuffled tables with holes over a pool whose trash page is poisoned
    to 1e4; the last slot has no mapped page at all (finite output)."""
    from repro_torch.kernels.paged_attention import ops, ref

    rng = np.random.default_rng(1)
    cur = rng.integers(lo, hi, size=B).astype(np.int32)
    table = _page_table(rng, B, maxp, P, cur, ps, holes)
    table[-1] = -1
    q = _rand(gen, (B, H, dh), dtype)
    kp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
    vp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
    kp[P] = 1e4
    vp[P] = 1e4
    tab, cur_t = torch.from_numpy(table).cuda(), torch.from_numpy(cur).cuda()
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, kp, vp, tab, cur_t)
    want = ref.paged_decode_attention_ref(q, kp, vp, tab, cur_t)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    assert bool(torch.isfinite(got).all())
    # relative above magnitude 1: the unmapped slot averages the trash page
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "split-boundaries", "fully-unmapped", "split-all-skipped",
    "splits-more-than-mapped-pages", "ragged-last-split", "page-size-4",
    "page-size-8", "gqa16:1-dh64", "gqa16:1-dh128"])
def test_paged_decode_attention_split_cases_match_ref(gen, dtype, case):
    """The split pass and the merge on the splits ``plan_page_splits``
    picks (6 of 4 pages at the paged path's shape): cur_pos on both sides
    of split boundaries, slots with no mapped page, a split whose pages
    are all holes, more splits than mapped pages, a ragged last split of
    one page that holds cur_pos, pages of 4 and 8, GQA 16:1; one launch
    counted per call, the trash page poisoned to 1e4."""
    from repro_torch.kernels.paged_attention import kernel, ops, ref

    rng = np.random.default_rng(4)
    B, H, Hkv, dh, ps, maxp = 8, 16, 8, 128, 16, 21
    if case.startswith("page-size"):
        ps = int(case[-1])
        maxp = 336 // ps
    if case.startswith("gqa"):
        Hkv, dh = 1, int(case.split("dh")[1])
    P = B * maxp
    n_split, pps = kernel.plan_page_splits(B, Hkv, maxp)
    if case == "split-boundaries":
        cur = np.asarray([62, 63, 64, 65, 127, 128, 191, 255], np.int32)
    elif case == "ragged-last-split":
        assert maxp % pps == 1
        cur = rng.integers(maxp * ps - ps, maxp * ps, size=B).astype(np.int32)
    elif case == "splits-more-than-mapped-pages":
        cur = rng.integers(0, 3 * ps, size=B).astype(np.int32)
    else:
        cur = rng.integers(0, maxp * ps, size=B).astype(np.int32)
    table = _page_table(rng, B, maxp, P, cur, ps,
                        0.2 if case in ("split-boundaries", "page-size-4",
                                        "page-size-8") else 0.0)
    if case == "fully-unmapped":
        table[::2] = -1
    if case == "split-all-skipped":
        cur[:] = rng.integers(3 * pps * ps, maxp * ps, size=B)
        table = _page_table(rng, B, maxp, P, cur, ps, 0.0)
        table[:, pps:2 * pps] = -1
    if case == "splits-more-than-mapped-pages":
        assert n_split > (table >= 0).sum(axis=1).max()
    q = _rand(gen, (B, H, dh), dtype)
    kp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
    vp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
    kp[P] = 1e4
    vp[P] = 1e4
    tab, cur_t = torch.from_numpy(table).cuda(), torch.from_numpy(cur).cuda()
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, kp, vp, tab, cur_t)
    want = ref.paged_decode_attention_ref(q, kp, vp, tab, cur_t)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,H,Hkv,dh,ps,maxp,P,lo,hi,holes", [
    (8, 4, 16, 8, 128, 16, 21, 168, 256, 319, 0.0),
    (4, 2, 16, 1, 64, 16, 21, 96, 0, 330, 0.2),
    (3, 8, 8, 2, 128, 8, 6, 30, 0, 40, 0.3),
    (3, 6, 4, 2, 32, 4, 8, 24, 0, 26, 0.2),
    (3, 4, 8, 8, 64, 8, 6, 20, 0, 44, 0.0),
    (8, 4, 16, 8, 128, 16, 21, 168, 0, 40, 0.0),     # splits > mapped pages
    (4, 2, 16, 1, 128, 16, 21, 96, 0, 330, 0.2),     # GQA 16:1, 32 rows
    (4, 8, 16, 4, 128, 8, 40, 160, 0, 310, 0.2),     # W=8, 32 rows
    (8, 4, 16, 16, 128, 16, 21, 168, 256, 319, 0.2),  # group 1, 4 rows
])
def test_paged_verify_attention_kernel_matches_ref(gen, dtype, B, W, H, Hkv,
                                                   dh, ps, maxp, P, lo, hi,
                                                   holes):
    """Windows of W over shuffled tables with holes and a poisoned trash
    page; the last slot has no mapped page at all (finite output)."""
    from repro_torch.kernels.paged_attention import ops, ref

    rng = np.random.default_rng(2)
    cur = rng.integers(lo, hi, size=B).astype(np.int32)
    table = _page_table(rng, B, maxp, P,
                        np.minimum(cur + W - 1, maxp * ps - 1), ps, holes)
    table[-1] = -1
    q = _rand(gen, (B, W, H, dh), dtype)
    kp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
    vp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
    kp[P] = 1e4
    vp[P] = 1e4
    tab, cur_t = torch.from_numpy(table).cuda(), torch.from_numpy(cur).cuda()
    before = ops.paged_verify_attention.launches
    got = ops.paged_verify_attention(q, kp, vp, tab, cur_t)
    want = ref.paged_verify_attention_ref(q, kp, vp, tab, cur_t)
    torch.cuda.synchronize()
    assert ops.paged_verify_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["split-boundaries", "row-0-without-keys",
                                  "fully-unmapped", "sweep", "split-skipped"])
def test_paged_verify_attention_split_cases_match_ref(gen, dtype, case):
    """The split pass and the merge on the splits ``plan_page_splits``
    picks (6 of 4 pages at the speculative path's shape): windows that
    straddle split boundaries, a row 0 without keys (every page walked), a
    slot with no mapped page, cur_pos swept across page boundaries, and a
    window whose later splits are all skipped; one launch counted per
    call, the trash page poisoned to 1e4."""
    from repro_torch.kernels.paged_attention import kernel, ops, ref

    rng = np.random.default_rng(3)
    B, W, H, Hkv, dh, ps, maxp, P = 8, 4, 16, 8, 128, 16, 21, 168
    n_split, pps = kernel.plan_page_splits(B, Hkv, maxp)
    assert (n_split, pps) == (6, 4)
    if case == "split-boundaries":
        cur = np.asarray([62, 63, 64, 126, 127, 128, 190, 318], np.int32)
    elif case == "sweep":
        cur = np.asarray([12, 13, 14, 15, 16, 29, 31, 61], np.int32)
    else:
        cur = rng.integers(0, 300, size=B).astype(np.int32)
    table = _page_table(rng, B, maxp, P, np.minimum(cur + W - 1, maxp * ps - 1),
                        ps, 0.2 if case == "split-boundaries" else 0.0)
    if case == "row-0-without-keys":
        cur[:2] = [14, 15]
        table[:2] = -1
        table[:2, 1] = [P - 1, P - 2]
    if case == "fully-unmapped":
        table[::2] = -1
    if case == "split-skipped":
        cur[:] = 20
        table = _page_table(rng, B, maxp, P, cur + W - 1, ps, 0.0)
    q = _rand(gen, (B, W, H, dh), dtype)
    kp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
    vp = _rand(gen, (P + 1, ps, Hkv, dh), dtype)
    kp[P] = 1e4
    vp[P] = 1e4
    tab, cur_t = torch.from_numpy(table).cuda(), torch.from_numpy(cur).cuda()
    before = ops.paged_verify_attention.launches
    got = ops.paged_verify_attention(q, kp, vp, tab, cur_t)
    want = ref.paged_verify_attention_ref(q, kp, vp, tab, cur_t)
    torch.cuda.synchronize()
    assert ops.paged_verify_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1.0)).max().item()
    assert err <= TOL[dtype]


def test_paged_verify_attention_kernel_refuses_too_many_rows(gen):
    from repro_torch.kernels.paged_attention import ops

    q = _rand(gen, (1, 4, 16, 64), torch.float32)       # 4 * 16 rows > 32
    pool = _rand(gen, (3, 4, 1, 64), torch.float32)
    tab = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    cur = torch.zeros((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="at most 32"):
        ops.paged_verify_attention(q, pool, pool, tab, cur)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Lp,Sk,H,Hkv,dh,q_offset", [
    (8, 64, 192, 64, 16, 8, 128, 0),
    (3, 45, 77, 45, 16, 8, 128, 0),
    (2, 40, 100, 70, 16, 8, 128, 30),
    (2, 96, 64, 96, 8, 1, 64, 0),
    (2, 50, 0, 50, 4, 2, 32, 0),
    (2, 70, 130, 77, 4, 2, 32, 7),          # Lp not a multiple of 64, offset
    (3, 130, 65, 150, 16, 8, 128, 20),      # 3 q tiles over both phases
    (8, 64, 192, 64, 16, 16, 128, 0),       # group 1 (deepseek-moe-16b)
])
def test_prefix_flash_attention_kernel_matches_ref(gen, dtype, B, Sq, Lp, Sk,
                                                   H, Hkv, dh, q_offset):
    from repro_torch.kernels.prefix_attention import ops, ref

    q = _rand(gen, (B, Sq, H, dh), dtype)
    pk, pv = (_rand(gen, (B, Lp, Hkv, dh), dtype) for _ in range(2))
    k, v = (_rand(gen, (B, Sk, Hkv, dh), dtype) for _ in range(2))
    before = ops.prefix_flash_attention.launches
    got = ops.prefix_flash_attention(q, pk, pv, k, v, q_offset=q_offset)
    want = ref.prefix_flash_attention_ref(q, pk, pv, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert ops.prefix_flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
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


def test_paged_prefix_batcher_on_the_card_matches_the_plain_path(gen):
    """Reduced qwen3-0.6b at f32 on the card: a paged batcher with the
    prefix cache through the kernels (paged decode, prefix and flash) gives
    the plain path's tokens, and its admissions hit the cache."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32")
    params = init_params(cfg, 0)
    rng = np.random.default_rng(3)
    head = rng.integers(1, cfg.vocab, size=20).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(1, cfg.vocab, size=4)
                               .astype(np.int32)]) for _ in range(8)]
    outs = {}
    for impl in ("cuda", "torch"):
        before = (pa_ops.paged_decode_attention.launches,
                  pfx_ops.prefix_flash_attention.launches)
        b = ContinuousBatcher(params, cfg, ServingConfig(
            slots=4, prompt_len=24, max_len=48, chunk=4, paged=True,
            page_size=4, n_pages=40, prefix_cache=True, attn_impl=impl))
        reqs = [Request(rid=i, prompt=p, max_new=6 + i % 3, namespace="s")
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.run()
        outs[impl] = [r.out for r in reqs]
        assert all(r.done for r in reqs) and b.stats.prefix_hits > 0
        b.kv_pool.check()
        ran = (pa_ops.paged_decode_attention.launches - before[0],
               pfx_ops.prefix_flash_attention.launches - before[1])
        assert (ran[0] > 0 and ran[1] > 0) == (impl == "cuda")
    assert outs["cuda"] == outs["torch"]


def test_page_table_audit_on_the_card_matches_the_plain_path(gen):
    """Reduced qwen3-0.6b at f32 on the card with audit=True: an
    out-of-range id, then a double mapping, each injected into a live slot.
    The paged decode kernel reads the corrupt entries as unmapped, the
    audit repairs both on the chunk's one fetch, quarantines the stolen
    page, and tokens, counters, quarantine and pool agree with the plain
    path on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32")
    params = init_params(cfg, 0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=1 + i % 6).astype(np.int32)
               for i in range(6)]
    outs = {}
    for impl in ("cuda", "torch"):
        before = pa_ops.paged_decode_attention.launches
        b = ContinuousBatcher(params, cfg, ServingConfig(
            slots=4, prompt_len=8, max_len=64, chunk=4, paged=True,
            page_size=8, audit=True, attn_impl=impl))
        reqs = [Request(rid=i, prompt=p, max_new=24) for i, p in
                enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.step()
        b.step()
        b.inject_kv_corruption(0)
        b.step()
        assert b.stats.audit_repairs >= 1
        live = [i for i, r in enumerate(b.slot_req) if r is not None]
        row = b.pages.table[live[1]].cpu().numpy()
        stolen = int(row[row >= 0][0])
        b.inject_kv_corruption(live[0], pid=stolen)
        b.step()
        b.run()
        torch.cuda.synchronize()
        assert stolen in b._quarantined and b.stats.quarantined_pages == 1
        assert all(r.done and len(r.out) == r.max_new for r in reqs)
        tab = b.pages.table.cpu().numpy()
        top = int(b.pages.free_top)
        free = set(b.pages.free[:top].tolist())
        assert not (b._quarantined & free)
        assert sorted(set(tab[tab >= 0].tolist()) | free | b._quarantined) \
            == list(range(b.n_pages))
        b.kv_pool.check()
        ran = pa_ops.paged_decode_attention.launches - before
        assert (ran > 0) == (impl == "cuda")
        outs[impl] = ([r.out for r in reqs], b.stats.as_dict(),
                      sorted(b._quarantined))
    assert outs["cuda"] == outs["torch"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_overlap_batcher_on_the_card_matches_the_plain_path(gen, paged):
    """Reduced qwen3-0.6b at f32 on the card: speculative decode with
    overlap through the kernels gives the plain path's tokens, which equal
    plain greedy decode; paged, every verify window launched the verify
    kernel, dense, none did."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32")
    params = init_params(cfg, 0)
    rng = np.random.default_rng(5)
    head = rng.integers(1, cfg.vocab, size=8).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(1, cfg.vocab, size=4)
                               .astype(np.int32)]) for _ in range(6)]
    kw = dict(slots=4, prompt_len=12, max_len=48, chunk=4)
    if paged:
        kw.update(paged=True, page_size=4, n_pages=48, prefix_cache=True)
    outs = {}
    for name, extra in (("plain", dict(attn_impl="torch")),
                        ("torch", dict(attn_impl="torch", speculative=True,
                                       overlap=True)),
                        ("cuda", dict(attn_impl="cuda", speculative=True,
                                      overlap=True))):
        before = pa_ops.paged_verify_attention.launches
        b = ContinuousBatcher(params, cfg, ServingConfig(**kw, **extra))
        reqs = [Request(rid=i, prompt=p, max_new=12 + i % 3, namespace="s")
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.run()
        outs[name] = [r.out for r in reqs]
        assert all(r.done for r in reqs)
        ran = pa_ops.paged_verify_attention.launches - before
        if name == "cuda" and paged:
            assert ran == cfg.n_layers * b.stats.steps // 4
        else:
            assert ran == 0
    assert outs["cuda"] == outs["torch"] == outs["plain"]


@pytest.mark.parametrize("mode", ["dense", "paged-prefix", "spec-overlap"])
def test_moe_batcher_on_the_card_matches_the_plain_path(gen, mode):
    """Reduced deepseek-moe-16b (group 1, MoE layers) at f32 on the card:
    the batcher through the kernels gives the plain path's tokens and
    stats in each serving mode, and every admission and step launched the
    mode's kernels."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.prefix_attention import ops as pfx_ops
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    cfg = dataclasses.replace(get_reduced("deepseek-moe-16b"), dtype="float32")
    params = init_params(cfg, 0)
    rng = np.random.default_rng(6)
    head = rng.integers(1, cfg.vocab, size=16).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(1, cfg.vocab, size=5 + i % 4)
                               .astype(np.int32)]) for i in range(10)]
    kw = dict(slots=4, prompt_len=32, max_len=64, chunk=4)
    if mode != "dense":
        kw.update(paged=True, page_size=8, prefix_cache=True)
    if mode == "spec-overlap":
        kw.update(speculative=True, draft_window=4, overlap=True)
    counters = (fa_ops.flash_attention, pfx_ops.prefix_flash_attention,
                da_ops.decode_attention, pa_ops.paged_decode_attention,
                pa_ops.paged_verify_attention)
    outs = {}
    for impl in ("cuda", "torch"):
        before = [c.launches for c in counters]
        b = ContinuousBatcher(params, cfg, ServingConfig(attn_impl=impl, **kw))
        reqs = [Request(rid=i, prompt=p, max_new=10 + i % 4, namespace="m")
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.run()
        assert all(r.done and len(r.out) == r.max_new for r in reqs)
        outs[impl] = ([r.out for r in reqs], b.stats.as_dict())
        fa, pfx, da, pa, pv = (c.launches - n
                               for c, n in zip(counters, before))
        st, L = b.stats, cfg.n_layers
        assert (st.prefix_hits > 0) == (mode != "dense")
        if impl == "torch":
            assert fa == pfx == da == pa == pv == 0
        elif mode == "dense":
            assert (fa, da, pa, pv) == (L * st.prefills, L * st.steps, 0, 0)
        elif mode == "paged-prefix":
            assert fa + pfx == L * st.prefills and pfx > 0
            assert (pa, da, pv) == (L * st.steps, 0, 0)
        else:
            assert fa + pfx == L * st.prefills
            assert (pv, pa, da) == (L * st.steps // 4, 0, 0)
    assert outs["cuda"] == outs["torch"]


def _rel(a, b):
    """Max abs error relative to ``b``'s largest magnitude."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _ssd_inputs(gen, B, S, nh, hd, G, N, dtype, dt_scale=1.0,
                dt_range=None):
    x = (_rand(gen, (B, S, nh, hd), torch.float32) * 0.5).to(dtype)
    if dt_range is None:
        dt = torch.nn.functional.softplus(
            _rand(gen, (B, S, nh), torch.float32)) * dt_scale
    else:                                   # log-uniform over the range
        lo, hi = dt_range
        dt = lo * (hi / lo) ** torch.rand((B, S, nh), generator=gen,
                                          device="cuda")
    A = -torch.exp(_rand(gen, (nh,), torch.float32) * 0.5)
    Bm = (_rand(gen, (B, S, G, N), torch.float32) * 0.3).to(dtype)
    Cm = (_rand(gen, (B, S, G, N), torch.float32) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,G,N,chunk,dt_scale", [
    (8, 1024, 32, 64, 1, 128, 256, 1.0),     # every mamba2-370m admission
    (2, 700, 8, 64, 1, 128, 256, 1.0),       # S not a multiple of the chunk
    (2, 100, 8, 64, 1, 128, 256, 1.0),       # S < chunk
    (2, 512, 8, 64, 2, 128, 128, 1.0),       # G = 2, rep 4
    (2, 512, 8, 64, 1, 128, 256, 40.0),      # exp(cum) underflows
    (4, 96, 8, 32, 1, 16, 32, 1.0),          # the reduced config
    (2, 160, 4, 32, 2, 128, 64, 1.0),
    (2, 144, 4, 64, 1, 16, 48, 1.0),
])
def test_ssd_scan_kernel_matches_plain(gen, dtype, B, S, nh, hd, G, N, chunk,
                                       dt_scale):
    """y and the final state against ``ssd_chunked``, errors relative to
    its largest magnitude: 1e-4 in f32; in bf16 2e-2 for y (the plain
    version rounds C.B^T, the scores and both halves of y to bf16, the
    kernel rounds y once) and 1e-4 for the state (f32 in both)."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.ssm import ssd_chunked

    args = _ssd_inputs(gen, B, S, nh, hd, G, N, dtype, dt_scale)
    before = ops.ssd.launches
    y, st = ops.ssd(*args, chunk=chunk, return_state=True)
    want_y, want_st = ssd_chunked(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert ops.ssd.launches == before + 1
    assert y.shape == args[0].shape and y.dtype == dtype
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    assert _rel(y, want_y) <= TOL[dtype]
    assert _rel(st, want_st) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,G,N,chunk,dt_range", [
    (8, 1024, 32, 64, 1, 128, 256, (1e-4, 1e-2)),   # the admission shape
    (2, 700, 8, 64, 1, 128, 256, (1e-4, 1e-2)),     # ragged tail
    (4, 96, 8, 32, 1, 16, 32, (1e-3, 1e-1)),        # the reduced config
])
def test_ssd_scan_kernel_carries_the_state(gen, dtype, B, S, nh, hd, G, N,
                                           chunk, dt_range):
    """Slow decay: dt small enough that the state decays by exp(cum_L)
    of 0.1-0.9 over a whole chunk (checked), so y of every chunk after the
    first depends on the carried state and on the key tiles far below the
    diagonal.  With dt ~ 0.8 (the cases above) both vanish below the
    tolerance.  Tolerances as in ``test_ssd_scan_kernel_matches_plain``."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models.ssm import ssd_chunked

    args = _ssd_inputs(gen, B, S, nh, hd, G, N, dtype, dt_range=dt_range)
    x, dt, A = args[:3]
    n = S // chunk * chunk
    total = (dt[:, :n] * A).reshape(B, -1, chunk, nh).sum(2)
    assert 0.1 <= torch.exp(total).median().item() <= 0.9
    y, st = ops.ssd(*args, chunk=chunk, return_state=True)
    want_y, want_st = ssd_chunked(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    assert _rel(y, want_y) <= TOL[dtype]
    assert _rel(st, want_st) <= TOL[torch.float32]


def test_ssd_scan_kernel_refuses_what_it_does_not_take(gen):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel

    def args(hd=32, N=16, S=64, dtype=torch.float32):
        x = _rand(gen, (1, S, 4, hd), dtype)
        dt = torch.ones((1, S, 4), device="cuda")
        bc = _rand(gen, (1, S, 1, N), dtype)
        return x, dt, -torch.ones(4, device="cuda"), bc, bc.clone()

    with pytest.raises(ValueError, match="hd=48"):
        ssd_scan_kernel(*args(hd=48), chunk=32)
    with pytest.raises(ValueError, match="N=64"):
        ssd_scan_kernel(*args(N=64), chunk=32)
    with pytest.raises(ValueError, match="chunk=512"):
        ssd_scan_kernel(*args(S=512), chunk=512)
    with pytest.raises(ValueError, match="divide"):
        ssd_scan_kernel(*args(S=48), chunk=32)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan_kernel(*args(dtype=torch.float16), chunk=32)
    x, dt, A, Bm, Cm = args(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="strides"):
        ssd_scan_kernel(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                        A, Bm, Cm, chunk=32)
    flat = torch.empty(1 + x.numel(), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        ssd_scan_kernel(flat[1:].view(x.shape), dt, A, Bm, Cm, chunk=32)


def _xbc_inputs(gen, B, S, nh, hd, G, N, dt_range=None):
    """x, dt, A, Bm, Cm as the SSM block hands them over: bf16 views of one
    conv output (B, S, nh hd + 2 G N)."""
    d_in, gn = nh * hd, G * N
    xbc = torch.cat([_rand(gen, (B, S, d_in), torch.float32) * 0.5,
                     _rand(gen, (B, S, 2 * gn), torch.float32) * 0.3],
                    dim=-1).to(torch.bfloat16)
    _, dt, A, _, _ = _ssd_inputs(gen, B, S, nh, hd, G, N, torch.bfloat16,
                                 dt_range=dt_range)
    return (xbc[..., :d_in].view(B, S, nh, hd), dt, A,
            xbc[..., d_in:d_in + gn].view(B, S, G, N),
            xbc[..., d_in + gn:].view(B, S, G, N))


@pytest.mark.parametrize("B,S,nh,hd,G,N,chunk,dt_range", [
    (8, 1024, 32, 64, 1, 128, 256, None),          # mamba2-370m's admission
    (8, 1024, 32, 64, 1, 128, 256, (1e-4, 1e-2)),  # slow decay
    (4, 96, 8, 32, 1, 16, 32, (1e-3, 1e-1)),       # the reduced config
    (2, 512, 8, 64, 2, 128, 128, None),            # G = 2
    (2, 100, 8, 64, 1, 128, 256, None),            # S < chunk: L = 100
])
def test_ssd_scan_reads_the_model_layout_without_copies(
        gen, monkeypatch, B, S, nh, hd, G, N, chunk, dt_range):
    """The bf16 call takes the SSM block's views of ``xBC`` as they are: the
    launcher receives x, Bm and Cm at their own addresses and strides (no
    copy), the route counter shows the five passes, and y and the final
    state agree with ``ssd_chunked`` (2e-2 and 1e-4 of its largest
    magnitude)."""
    from repro_torch.kernels.ssd_scan import kernel, ops
    from repro_torch.models.ssm import ssd_chunked

    args = _xbc_inputs(gen, B, S, nh, hd, G, N, dt_range)
    seen = []

    def spy(*a, **kw):
        seen.append([(t.data_ptr(), t.stride()) for t in a])
        return kernel.ssd_scan_kernel(*a, **kw)

    monkeypatch.setattr(ops, "ssd_scan_kernel", spy)
    before = dict(ops.ssd.route_calls)
    y, st = ops.ssd(*args, chunk=chunk, return_state=True)
    want_y, want_st = ssd_chunked(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert seen == [[(t.data_ptr(), t.stride()) for t in args]]
    assert ops.ssd.route_calls["passes"] == before["passes"] + 1
    assert ops.ssd.route_calls["f32"] == before["f32"]
    assert y.shape == args[0].shape and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    assert _rel(y, want_y) <= TOL[torch.bfloat16]
    assert _rel(st, want_st) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "passes"),
                                         (torch.float32, "f32")])
def test_ssd_scan_routes_by_dtype(gen, dtype, route):
    from repro_torch.kernels.ssd_scan import ops

    args = _ssd_inputs(gen, 2, 128, 4, 32, 1, 16, dtype)
    before = dict(ops.ssd.route_calls)
    ops.ssd(*args, chunk=32)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in ops.ssd.route_calls.items()} == \
        {k: int(k == route) for k in before}


def _mamba2_dt_init(params, seed):
    """dt_bias and A_log as Mamba-2 initialises them (dt log-uniform over
    [1e-3, 1e-1], A uniform over [1, 16]), so some heads keep their state
    across a chunk; the port's init (A = -1, dt_bias = 0) forgets it."""
    rng = np.random.default_rng(seed)
    for block in params["blocks"]:
        ssm = block["ssm"]
        shape = tuple(ssm["dt_bias"].shape)
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=shape))
        ssm["dt_bias"].copy_(torch.from_numpy(dt + np.log(-np.expm1(-dt))))
        ssm["A_log"].copy_(torch.from_numpy(
            np.log(rng.uniform(1, 16, size=shape))))


def test_mamba2_batcher_on_the_card_matches_the_plain_path(gen):
    """Reduced mamba2-370m at f32 on the card, with Mamba-2's dt and A
    init: the batcher through the SSD kernel (the default impl and device)
    gives the plain path's tokens, and every admission launched the kernel
    once a layer."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

    cfg = dataclasses.replace(get_reduced("mamba2-370m"), dtype="float32")
    params = init_params(cfg, 0)
    _mamba2_dt_init(params, 1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, size=3 + 5 * i).astype(np.int32)
               for i in range(6)]
    outs = {}
    for impl in ("cuda", "torch"):
        before = ops.ssd.launches
        b = ContinuousBatcher(params, cfg, ServingConfig(
            slots=4, prompt_len=40, max_len=60, chunk=4, attn_impl=impl))
        reqs = [Request(rid=i, prompt=p, max_new=8 + i % 3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        b.run()
        outs[impl] = [r.out for r in reqs]
        assert all(r.done for r in reqs)
        ran = ops.ssd.launches - before
        assert ran == (cfg.n_layers * b.stats.prefills if impl == "cuda" else 0)
    assert outs["cuda"] == outs["torch"]


def _err(got, want):
    """Max abs error, relative where the plain output exceeds 1 (one bf16
    rounding step of a large output is 2^-8 of it)."""
    return ((got.float() - want.float()).abs()
            / want.float().abs().clamp(min=1.0)).max().item()


@pytest.mark.parametrize("x_dtype,s_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(2048, 1024), (8, 1024), (4, 32, 128),
                                   (7, 5120), (33, 130), (3, 12288)])
def test_rmsnorm_kernel_matches_plain(gen, x_dtype, s_dtype, shape):
    from repro_torch.kernels.rmsnorm import ops, ref

    x = _rand(gen, shape, x_dtype)
    s = _rand(gen, (shape[-1],), s_dtype)
    before = ops.rmsnorm.launches
    got = ops.rmsnorm(x, s)
    want = ref.rmsnorm_ref(x, s)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype
    assert bool(torch.isfinite(got).all())
    assert _err(got, want) <= TOL[x_dtype]


def test_rmsnorm_kernel_takes_a_misaligned_view(gen):
    """A row view whose start is off the 16-byte boundary (a storage offset
    of one element) goes through the scalar head of the kernel."""
    from repro_torch.kernels.rmsnorm import kernel, ref

    base = _rand(gen, (1 + 64 * 256,), torch.bfloat16)
    x = base[1:].view(64, 256)
    s = _rand(gen, (256,), torch.bfloat16)
    got = kernel.rmsnorm_kernel(x, s)
    torch.cuda.synchronize()
    assert _err(got, ref.rmsnorm_ref(x, s)) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,route", [
    ((2048, 1024), 0, "registers"),      # a warp a row
    ((64, 4096), 0, "registers"),        # a block a row
    ((3, 12288), 0, "registers"),        # the widest row
    ((64, 1024), 1, "two_pass"),         # one element off the boundary
])
def test_rmsnorm_routes_on_the_card(gen, x_dtype, s_dtype, shape, offset,
                                    route):
    """Aligned rows take the register route at d = 1024, 4096 and 12288,
    a row view one element off the 16-byte boundary the two-pass kernel,
    as the route counters show; errors as in
    ``test_rmsnorm_kernel_matches_plain``."""
    from repro_torch.kernels.rmsnorm import ops, ref

    base = _rand(gen, (offset + shape[0] * shape[1],), x_dtype)
    x = base[offset:].view(shape)
    s = _rand(gen, (shape[1],), s_dtype)
    before = dict(ops.rmsnorm.route_launches)
    got = ops.rmsnorm(x, s)
    want = ref.rmsnorm_ref(x, s)
    torch.cuda.synchronize()
    assert {k: n - before[k] for k, n in ops.rmsnorm.route_launches.items()} \
        == {k: int(k == route) for k in before}
    assert got.shape == x.shape and got.dtype == x.dtype
    assert _err(got, want) <= TOL[x_dtype]


def test_rmsnorm_register_route_raises_on_a_misaligned_view(gen):
    """Asked for the register route on rows off the 16-byte boundary, the
    launcher raises; it never gives way to the two-pass kernel."""
    from repro_torch.kernels.rmsnorm import kernel

    base = _rand(gen, (1 + 64 * 256,), torch.bfloat16)
    s = _rand(gen, (256,), torch.bfloat16)
    with pytest.raises(RuntimeError, match="registers"):
        kernel.rmsnorm_kernel(base[1:].view(64, 256), s, route="registers")
    with pytest.raises(RuntimeError, match="registers"):
        kernel.rmsnorm_kernel(_rand(gen, (4, 130), torch.bfloat16),
                              _rand(gen, (130,), torch.bfloat16),
                              route="registers")


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("sa,sb", [((2048, 1024), (1024, 3072)),
                                   ((8, 1024), (1024, 3072)),
                                   ((100, 300), (300, 72)),
                                   ((2, 50, 300), (300, 72)),
                                   ((1, 1), (1, 1))])
def test_matmul_kernel_matches_plain(gen, in_dtype, out_dtype, sa, sb):
    """Errors relative to the plain version's largest magnitude: 1e-5 at
    f32 output (summation order only), 8e-3 at bf16 output (one rounding,
    and a flip across a rounding boundary)."""
    from repro_torch.kernels.matmul import ops, ref

    a = _rand(gen, sa, in_dtype)
    b = _rand(gen, sb, in_dtype)
    before = ops.matmul.launches
    got = ops.matmul(a, b, out_dtype=out_dtype)
    want = ref.matmul_ref(a.reshape(-1, sa[-1]), b,
                          out_dtype=out_dtype).reshape(*sa[:-1], sb[-1])
    torch.cuda.synchronize()
    assert ops.matmul.launches == before + 1
    assert got.shape == want.shape and got.dtype == out_dtype
    scale = want.float().abs().max().clamp(min=1e-30)
    err = ((got.float() - want.float()).abs().max() / scale).item()
    assert err <= (1e-5 if out_dtype == torch.float32 else 8e-3)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("M,K,N", [(2048, 1024, 3072), (2048, 3072, 1024),
                                   (8, 1024, 3072), (100, 300, 72)])
def test_matmul_routes_on_the_card(gen, in_dtype, out_dtype, M, K, N):
    """The phase-3 shapes: the bf16 2048-row and decode products go through
    the wgmma route, the ragged one (600-byte rows of a) and f32 through the
    CUDA-core kernel, as the route counters show; errors as in
    ``test_matmul_kernel_matches_plain``."""
    from repro_torch.kernels.matmul import ops, ref

    a = _rand(gen, (M, K), in_dtype)
    b = _rand(gen, (K, N), in_dtype)
    before = dict(ops.matmul.route_launches)
    got = ops.matmul(a, b, out_dtype=out_dtype)
    want = ref.matmul_ref(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    route = ("wgmma" if in_dtype == torch.bfloat16 and K % 8 == 0
             else "cuda_core")
    assert {k: n - before[k] for k, n in ops.matmul.route_launches.items()} \
        == {k: int(k == route) for k in before}
    err = _rel(got, want)
    assert err <= (1e-5 if out_dtype == torch.float32 else 8e-3)


def test_matmul_wgmma_route_raises_where_tma_cannot_read(gen):
    """Asked for the wgmma route on what TMA cannot describe, the launcher
    raises; it never gives way to the other route."""
    from repro_torch.kernels.matmul import kernel

    a = _rand(gen, (100, 300), torch.bfloat16)
    b = _rand(gen, (300, 72), torch.bfloat16)
    with pytest.raises(RuntimeError, match="wgmma"):
        kernel.matmul_kernel(a, b, route="wgmma")
    with pytest.raises(RuntimeError, match="wgmma"):
        kernel.matmul_kernel(a.float(), b.float(), route="wgmma")


def test_rmsnorm_and_matmul_refuse_what_they_do_not_take(gen):
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.rmsnorm import ops as rms

    x = _rand(gen, (4, 8), torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        rms.rmsnorm(x, _rand(gen, (8,), torch.float32))
    with pytest.raises(ValueError, match="d="):
        rms.rmsnorm(_rand(gen, (1, 12289), torch.float32),
                    _rand(gen, (12289,), torch.float32))
    a = _rand(gen, (4, 8), torch.float32)
    with pytest.raises(ValueError, match="dtypes"):
        mm.matmul(a, _rand(gen, (8, 3), torch.bfloat16))
    with pytest.raises(ValueError, match="out_dtype"):
        mm.matmul(a, _rand(gen, (8, 3), torch.float32),
                  out_dtype=torch.float16)


def test_tenant_program_runs_through_the_hypervisor_on_the_card(gen):
    """The static stage warms a program that reaches both kernels on
    cuda:0 for every lease size; a regrow between calls hits the cache and
    the program keeps launching the kernels."""
    from repro_torch.core import TenantSpec
    from repro_torch.kernels.matmul import ops as mm
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.serving import (
        TensorSpec, VirtualAcceleratorPool, make_serving_hypervisor,
    )

    def program(x, s, w):
        return mm.matmul(rms.rmsnorm(x, s), w)

    pool = VirtualAcceleratorPool(devices=[torch.device("cuda", 0)] * 4)
    hv, ex = make_serving_hypervisor(pool, policy="priority")
    before = (rms.rmsnorm.launches, mm.matmul.launches)
    specs = (TensorSpec((64, 128), torch.bfloat16),
             TensorSpec((128,), torch.bfloat16),
             TensorSpec((128, 96), torch.bfloat16))
    ex.compiler.static_compile("p", program, specs, lease_sizes=[2, 4])
    assert (rms.rmsnorm.launches, mm.matmul.launches) == \
        (before[0] + 2, before[1] + 2)
    assert hv.admit(TenantSpec("t", 2, artifact="p"))
    hv.resize_request("t", 4)
    assert ex.program_of("t").n_cores == 4
    x, s, w = (_rand(gen, sp.shape, sp.dtype) for sp in specs)
    got = ex.program_of("t").executable(x, s, w)
    torch.cuda.synchronize()
    from repro_torch.kernels.matmul import ref as mm_ref
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    want = mm_ref.matmul_ref(rms_ref.rmsnorm_ref(x, s), w)
    assert ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item() <= 8e-3


def test_paged_batcher_resize_between_chunks_on_the_card(gen):
    """A hypervisor regrow between chunks migrates a paged batcher's live
    state on cuda:0 (``live_state`` waits for the queued chunk first) and
    the tokens equal an uninterrupted run."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import TenantSpec
    from repro_torch.models import init_params
    from repro_torch.serving import (
        ContinuousBatcher, Request, ServingConfig, TensorSpec,
        VirtualAcceleratorPool, make_serving_hypervisor,
    )

    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    sc = ServingConfig(slots=4, prompt_len=8, max_len=64, chunk=4,
                       paged=True, page_size=8, overlap=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, size=4 + i).astype(np.int32)
               for i in range(5)]

    def reqs():
        return [Request(rid=i, prompt=p, max_new=5 + 2 * i)
                for i, p in enumerate(prompts)]

    ref = ContinuousBatcher(params, cfg, sc)
    ref_reqs = reqs()
    for r in ref_reqs:
        ref.submit(r)
    ref.run()
    pool = VirtualAcceleratorPool(devices=[torch.device("cuda", 0)] * 4)
    hv, ex = make_serving_hypervisor(pool, policy="no_realloc")
    ex.compiler.static_compile("k", lambda x: x,
                               (TensorSpec((4,), torch.float32),),
                               lease_sizes=[1, 2])
    assert hv.admit(TenantSpec("t", 1, artifact="k"))
    b = ContinuousBatcher(params, cfg, sc)
    ex.register_state("t", b.live_state, on_migrate=b.adopt_state)
    got = reqs()
    for r in got:
        b.submit(r)
    b.step()
    hv.resize_request("t", 2)
    assert "t_migrate" in ex.reconfig_log[-1]
    b.run()
    assert [r.out for r in got] == [r.out for r in ref_reqs]
