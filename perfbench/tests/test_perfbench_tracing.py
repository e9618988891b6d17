"""The readings of the program's own tracing on the CPU at a small size:
``serving_trace.py``'s host-side readings and its launch counts on hand-built
events, and the queue-wait reader of a traced run."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from perfbench import harness, serving_trace
from perfbench.tests.small import small_plan

SEED = 2**31 + 977
CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _queue_wait_reader():
    plan = harness.load_plan("qwen3-0.6b.unshared")
    return harness.load_reader(plan.files["metric:batcher.queue_wait_p95_ms"])


@pytest.mark.parametrize("cell", ["qwen3-0.6b.unshared",
                                  "dsmoe16b.long-prompt"])
def test_serving_trace_reads_the_host_side(cell):
    torch.set_num_threads(1)
    plan, cfg = small_plan(cell)
    out = serving_trace.run(plan, SEED, 0.4, 2, device="cpu",
                            model_cfg=cfg, log=lambda m: None)
    assert [w["traced"] for w in out["windows"]] == [False, True]
    assert out["tokens_per_s"]["untraced"] > 0
    assert out["tokens_per_s"]["traced"] > 0
    got = out["metrics"]
    assert got["batcher.queue_wait_p95_ms"] >= 0
    assert 0 < got["batcher.admit_pad_share"] < 100
    assert got["batcher.dispatch_ms_per_step"] > 0
    # the device's readings need the card
    assert got["decode.launches_per_step"] is None
    assert got["decode.bookkeeping_launch_share"] is None
    assert out["segment"]["steps"] > 0 and out["segment"]["kernels"] == 0


def _evt(name, start, end, device=CPU, annotation=False, thread=1):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_launch_counts_on_a_hand_built_segment():
    """Two dispatches, each with one model range: 5 launches in the first
    (3 in the model), 3 in the second (2 in the model), one between them
    and one on another thread; the ranges' GPU-side annotations are not
    kernels."""
    events = [
        _evt("serving.dispatch", 0, 100, annotation=True),
        _evt("serving.decode_model", 10, 50, annotation=True),
        _evt("serving.dispatch", 200, 300, annotation=True),
        _evt("serving.decode_model", 210, 260, annotation=True),
        _evt("serving.dispatch", 20, 400, CUDA, annotation=True),
        _evt("serving.decode_model", 30, 120, CUDA),
        _evt("moe.expert_products", 40, 60, CUDA, annotation=True),
    ]
    launch_t = [5, 20, 30, 45, 80, 150, 220, 230, 280]
    for i, t in enumerate(launch_t):
        events.append(_evt("cudaLaunchKernel", t, t + 1))
        events.append(_evt(f"kernel_{i}", 100 + 10 * i, 105 + 10 * i, CUDA))
    events.append(_evt("cudaLaunchKernel", 240, 241, thread=2))
    counts = serving_trace.launch_counts(events)
    assert counts["kernels"] == 9 and counts["annotations"] == 3
    assert counts["launches"] == {"all": 10, "serving.dispatch": 8,
                                  "serving.decode_model": 5}
    assert counts["busy_s"] == pytest.approx(9 * 5e-6)
    assert counts["busy_s_with_annotations"] == pytest.approx(380e-6)
    got = serving_trace.device_readings(counts, steps=2)
    assert got["decode.launches_per_step"] == 4.0
    assert got["decode.bookkeeping_launch_share"] == pytest.approx(37.5)
    assert counts["launches"]["serving.dispatch"] <= counts["kernels"]


def test_device_readings_read_nothing_without_kernels():
    counts = serving_trace.launch_counts(
        [_evt("serving.dispatch", 0, 100, annotation=True),
         _evt("aten::mm", 10, 20)])
    assert serving_trace.device_readings(counts, steps=8) == {
        "decode.launches_per_step": None,
        "decode.bookkeeping_launch_share": None}


def test_first_token_stamps_share_the_recorders_round():
    """On one clock, each request's ``t_first`` (the batcher's) and the
    harness's ``first_t`` fall in the same round."""
    from repro_torch.serving import Request

    from perfbench.traffic import gen

    torch.set_num_threads(1)
    plan, cfg = small_plan("qwen3-0.6b.unshared")
    b, _ = serving_trace.build(plan, SEED, "cpu", cfg)
    rec = harness.Recorder(b, clock=time.perf_counter)
    loop = harness.Loop(b, gen.make(plan.mix, SEED, cfg.vocab), rec, Request)
    rounds = []
    for _ in range(12):
        t0 = time.perf_counter()
        loop.round(3)
        rounds.append((t0, time.perf_counter()))

    def which(t):
        return next(i for i, (a, z) in enumerate(rounds) if a <= t <= z)

    served = [r for r in rec.by_rid.values() if r.first_t is not None]
    assert len(served) > 6
    for r in served:
        assert which(r.req.t_first) == which(r.first_t)
        assert r.req.t_first <= r.first_t


def _req(rid, submit, first, t_admit=None):
    req = SimpleNamespace(t_submit=submit, t_admit=t_admit)
    return harness.Req(spec=None, rid=rid, submit_t=submit, req=req,
                       first_t=first)


def test_queue_wait_reader_finds_the_window_by_its_ttfts():
    """Warm-up requests before the window, an admission of two requests
    after it (in the profiled rounds) that a cut must not split, and a
    request still queued: the reader takes the window's requests alone."""
    reqs = [_req(0, 0.0, 1.0, 0.5), _req(1, 0.0, 1.0, 0.5),     # warm-up
            _req(2, 1.5, 3.0, 2.5), _req(3, 1.5, 3.0, 2.0),     # window
            _req(4, 3.0, 4.0, 3.1),                             # window
            _req(5, 4.0, 6.0, 5.9), _req(6, 4.5, 6.0, 5.9),     # after
            _req(7, 6.0, None)]                                 # queued
    window = [reqs[i] for i in (2, 3, 4)]
    run = SimpleNamespace(reqs={r.rid: r for r in reqs},
                          ttft=[r.first_t - r.submit_t for r in window])
    read = _queue_wait_reader()
    # p95 (nearest rank) of waits 1.0, 0.5, 0.1 s
    assert read(run) == pytest.approx(1000.0)
    # a program without the stamps reads nothing
    for r in reqs:
        r.req = SimpleNamespace()
    assert read(run) is None


def test_traced_run_reports_the_queue_wait():
    torch.set_num_threads(1)
    plan, cfg = small_plan("qwen3-0.6b.unshared")
    assert "batcher.queue_wait_p95_ms" in {m["name"] for m in plan.per_layer}
    out = harness.run(plan, SEED, 1.5, True, time.perf_counter(),
                      device="cpu", model_cfg=cfg, log=lambda m: None)
    assert out["correct"]
    assert out["metrics"]["batcher.queue_wait_p95_ms"]["value"] >= 0
