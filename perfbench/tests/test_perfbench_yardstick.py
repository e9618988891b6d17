"""The yardstick's arithmetic against hand sums: quantiles, the window's
rates, active parameters, model FLOPs and the kernels' bounds."""

from __future__ import annotations

import types

import pytest

from perfbench import harness, yardstick
from perfbench.tests.small import small_plan


def test_percentile_nearest_rank():
    vals = list(range(1, 101))              # 1 .. 100
    assert yardstick.percentile(vals, 0.95) == 96
    assert yardstick.percentile(vals, 0.5) == 51
    assert yardstick.percentile([3.0], 0.95) == 3.0
    assert yardstick.percentile([5, 1, 4, 2, 3], 0.95) == 5
    assert yardstick.percentile([], 0.95) != yardstick.percentile([], 0.95)


def _req(rid, submit, first, last, done, n_out):
    return harness.Req(spec=types.SimpleNamespace(max_new=n_out), rid=rid,
                       submit_t=submit, req=types.SimpleNamespace(
                           out=[0] * n_out, dropped=False),
                       first_t=first, last_t=last, done_t=done)


def test_window_rates():
    rec = types.SimpleNamespace(arrivals=[(0.5, 8), (1.5, 10), (2.5, 7),
                                          (3.5, 9)],
                                by_rid={}, completed=[])
    a = _req(0, 0.9, 1.5, 2.5, 2.5, 5)      # first and done inside
    b = _req(1, 0.2, 0.5, 3.5, 3.5, 4)      # first before the window
    c = _req(2, 2.0, 2.5, 2.5, None, 1)     # not done
    rec.by_rid = {0: a, 1: b, 2: c}
    rec.completed = [a, b]
    tokens, ttft, tpot, done = harness.window_e2e(rec, 1.0, 3.0)
    assert tokens == 10 + 7
    assert sorted(ttft) == pytest.approx([0.5, 0.6])
    assert done == [a] and tpot == pytest.approx([1.0 / 4])


def test_active_params_by_hand():
    plan, cfg = small_plan("dsmoe16b.long-prompt")
    m = yardstick.dims(plan.conf)
    d, f, E, k, ns = 128, 96, 8, 2, 2
    attn = d * (4 * 32 + 2 * 4 * 32) + 4 * 32 * d   # q, k, v, o
    per_layer = attn + d * E + (k + ns) * 3 * d * f
    assert yardstick.active_params_per_token(m) == 2 * per_layer
    # the program's own count adds the embedding and LM head
    # (vocab padded) and every MoE weight's active share
    program = cfg.param_count(active_only=True)
    assert program == 2 * per_layer + 2 * 512 * d

    plan, cfg = small_plan("qwen3-0.6b.unshared")
    m = yardstick.dims(plan.conf)
    layer = 128 * (4 * 32 + 2 * 2 * 32) + 4 * 32 * 128 + 3 * 128 * 384
    assert yardstick.active_params_per_token(m) == 2 * layer


def test_model_flops_by_hand():
    plan, _ = small_plan("qwen3-0.6b.unshared")
    m = yardstick.dims(plan.conf)
    n = yardstick.active_params_per_token(m)
    w = yardstick.Work()
    w.add_prompt(3, 0)           # keys seen: 1 + 2 + 3
    w.add_prompt(2, 4)           # after 4 cached: 5 + 6
    w.add_decode(10)
    ctx = 6 + 11 + 10
    want = (2.0 * n * 6 + 2.0 * 128 * 512 * 3
            + 4.0 * 2 * 4 * 32 * ctx)
    assert w.model_flops(m) == pytest.approx(want)
    assert yardstick.mfu(w, m, 2.0) == pytest.approx(
        want / (2.0 * yardstick.PEAK_BF16_FLOPS))


def test_kernel_bounds_by_hand():
    plan, _ = small_plan("qwen3-0.6b.unshared")
    m = yardstick.dims(plan.conf)        # 4:2 heads of 32
    ctx = [17, 40]
    nbytes = sum(2 * 128 * 2 + 2 * c * 64 * 2 + 4 * -(-c // 16) for c in ctx)
    flops = sum(4 * 4 * 32 * c for c in ctx)
    assert yardstick.paged_decode_bound_s(m, ctx, 16) == pytest.approx(max(
        flops / yardstick.PEAK_BF16_FLOPS,
        nbytes / yardstick.PEAK_HBM_BYTES_S))
    rows = [(5, 0), (3, 16)]
    flops = 4 * 4 * 32 * (15 + (17 + 18 + 19))
    nbytes = (5 + 3) * (2 * 128 + 2 * 64) * 2 + 16 * 2 * 64 * 2
    assert yardstick.prefill_attn_bound_s(m, rows) == pytest.approx(max(
        flops / yardstick.PEAK_BF16_FLOPS,
        nbytes / yardstick.PEAK_HBM_BYTES_S))


def test_kernel_names_and_union():
    name = ("void (anonymous namespace)::paged_decode_split_kernel"
            "<__nv_bfloat16, 128>(__nv_bfloat16 const*, int)")
    assert harness.kernel_base(name) == "paged_decode_split_kernel"
    assert harness.kernel_base(
        "void at::native::elementwise_kernel<128, 4>(int)") == \
        "at::native::elementwise_kernel"
    assert harness.kernel_base("nvjet_tst_256x64_NNT") == \
        "nvjet_tst_256x64_NNT"
    spans = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0)]
    assert harness.union_us(spans) == 4.0
    seg = harness.Segment(wall_s=1e-5, rounds=[], kernels=spans + [
        (name, 7.0, 9.0)], host_spans=[("dispatch", 2.5, 8.0),
                                        ("sync_wait", 3.5, 4.5)])
    assert seg.kernel_us(("paged_decode_split_kernel",)) == 2.0
    gaps = dict(harness.idle_gaps(seg))
    assert gaps["sync_wait"] == pytest.approx(2e-6)    # 3 .. 5
    assert gaps["dispatch"] == pytest.approx(1e-6)     # 6 .. 7
