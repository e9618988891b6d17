"""Measure the serving loop of one cell with the program's own tracing on.

    python3 perfbench/serving_trace.py --workload <name> --seed <n> \
        --seconds <s> [--windows 4]

Builds the cell's batcher as ``run.py`` does, with the program's tracer on
the batcher's clock (``time.perf_counter``, the clock the harness's
``Recorder`` stamps with), warms up, then runs ``--windows`` windows of
``--seconds`` each, untraced and traced in turn in one process, and
profiles a few traced rounds after them.  Prints one JSON object as the
last line of standard output: each window's tokens/s (the cost of
tracing), and five readings of the serving loop:

* ``batcher.queue_wait_p95_ms``: p95 (nearest rank) of the program's
  ``t_admit - t_submit`` over the requests admitted in the windows;
* ``batcher.admit_pad_share``: ``serving.admit_pad_tokens`` over
  ``serving.admit_computed_tokens`` (registry counters) in the windows;
* ``batcher.dispatch_ms_per_step``: the tracer's ``dispatch`` spans over
  the decode steps they dispatched, in the traced windows;
* ``decode.launches_per_step``: kernel launches the host made inside the
  program's ``serving.dispatch`` ranges over the profiled decode steps;
* ``decode.bookkeeping_launch_share``: the share of those launches made
  outside ``serving.decode_model`` (page faults, token selection, the EOS
  and budget mask, page frees, counters, the fetch packing).

The last two need the card's trace and read ``null`` elsewhere.  The
profiled segment also reports the device's busy time with the ranges'
GPU-side annotations kept out of the kernels and counted as kernels.
No reference check runs here: ``run.py`` judges what the program serves.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROFILE_ROUNDS = 3
# host calls that enqueue one kernel each
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaLaunchCooperativeKernel"})


def build(plan, seed: int, device: str, model_cfg=None):
    """The cell's batcher on the benchmark's weights, its tracer (off) and
    the batcher both on ``time.perf_counter``."""
    from repro_torch.configs import get_config
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    from perfbench import harness, weights

    cfg = model_cfg or get_config(plan.conf["program"]["arch"])
    harness.check_program(cfg, plan.conf)
    params = weights.make(plan.conf, seed, device)
    serving = dict(plan.conf["program"]["serving"], **plan.mix["serving"])
    tracer = Tracer(clock=time.perf_counter, enabled=False)
    b = ContinuousBatcher(params, cfg, ServingConfig(**serving),
                          device=device, clock=time.perf_counter,
                          telemetry=Telemetry(tracer=tracer))
    return b, tracer


def _counters(b) -> Dict[str, int]:
    reg, tenant = b.telemetry.registry, b.telemetry.tenant
    return {name: reg.counter(name, tenant).value
            for name in ("serving.admit_computed_tokens",
                         "serving.admit_pad_tokens", "serving.steps")}


def host_readings(reqs, tracer_events, traced, t_open: float,
                  t_close: float, c0: Dict, c1: Dict) -> Dict:
    """The three host-side readings over the windows ``(t_open,
    t_close]``; ``traced`` lists the traced windows' bounds."""
    from perfbench import yardstick

    waits = [r.t_admit - r.t_submit for r in reqs
             if r.t_admit is not None and t_open < r.t_admit <= t_close]
    computed = (c1["serving.admit_computed_tokens"]
                - c0["serving.admit_computed_tokens"])
    pad = c1["serving.admit_pad_tokens"] - c0["serving.admit_pad_tokens"]
    spans = [e for e in tracer_events if e["ph"] == "X"
             and e["name"] == "dispatch"
             and any(a < e["ts"] <= b for a, b in traced)]
    steps = sum(e["args"]["T"] for e in spans)
    return {
        "batcher.queue_wait_p95_ms": (1e3 * yardstick.percentile(waits, 0.95)
                                      if waits else None),
        "batcher.admit_pad_share": (100.0 * pad / computed if computed
                                    else None),
        "batcher.dispatch_ms_per_step": (
            1e3 * sum(e["dur"] for e in spans) / steps if steps else None),
    }


def launch_counts(events) -> Dict:
    """Kernels and host launches of a profiled segment's events: the
    device's kernels (GPU-side annotations of ranges kept out), their busy
    time with and without those annotations counted as kernels, and the
    host's launch calls in all, inside ``serving.dispatch`` and inside
    ``serving.decode_model`` (by host time, on the launching thread)."""
    from torch.autograd import DeviceType

    from perfbench import harness

    ranges = [e for e in events if e.device_type == DeviceType.CPU
              and e.name in ("serving.dispatch", "serving.decode_model")]
    names = {e.name for e in events if e.device_type == DeviceType.CPU
             and getattr(e, "is_user_annotation", False)}
    names |= {e.name for e in ranges}
    kernels, annotations = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.name, e.time_range.start, e.time_range.end)
        annotation = getattr(e, "is_user_annotation", False) \
            or e.name in names
        (annotations if annotation else kernels).append(span)
    inside: Dict[str, Dict] = {}
    for e in ranges:
        by = inside.setdefault(e.name, {}).setdefault(e.thread, [])
        by.append((e.time_range.start, e.time_range.end))
    for by in inside.values():
        for iv in by.values():
            iv.sort()
    launches = {"all": 0, "serving.dispatch": 0, "serving.decode_model": 0}
    runtime = collections.Counter()
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith("cu"):
            runtime[e.name] += 1
        if e.name not in LAUNCH_CALLS:
            continue
        launches["all"] += 1
        t = e.time_range.start
        for name, by in inside.items():
            iv = by.get(e.thread, [])
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                launches[name] += 1
    return {"kernels": len(kernels), "annotations": len(annotations),
            "launches": launches,
            "runtime_calls": dict(runtime.most_common(8)),
            "busy_s": harness.union_us(kernels) * 1e-6,
            "busy_s_with_annotations":
                harness.union_us(kernels + annotations) * 1e-6}


def device_readings(counts: Dict, steps: int) -> Dict:
    """The two device-trace readings of a segment's :func:`launch_counts`
    over its ``steps`` decode steps; ``None`` without kernels."""
    n = counts["launches"]["serving.dispatch"]
    if not counts["kernels"] or not n or not steps:
        return {"decode.launches_per_step": None,
                "decode.bookkeeping_launch_share": None}
    model = counts["launches"]["serving.decode_model"]
    return {"decode.launches_per_step": n / steps,
            "decode.bookkeeping_launch_share": 100.0 * (n - model) / n}


def run(plan, seed: int, seconds: float, windows: int, *,
        device: str = "cuda", model_cfg=None, log=print) -> Dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    from perfbench import harness, yardstick
    from perfbench.traffic import gen

    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    b, tracer = build(plan, seed, device, model_cfg)
    traffic = gen.make(plan.mix, seed, yardstick.dims(plan.conf).vocab)
    rec = harness.Recorder(b)
    loop = harness.Loop(b, traffic, rec, Request)
    ramp = int(plan.mix.get("ramp", traffic.clients))
    for _ in range(int(plan.mix["warmup_rounds"])):
        loop.round(ramp)
    sync()
    gc.collect()
    log(f"setup {time.perf_counter() - T_START:.3f} s")
    c0 = _counters(b)
    bounds, rows = [], []
    for i in range(windows):
        tracer.enabled = i % 2 == 1
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            loop.round(ramp)
        sync()
        t1 = time.perf_counter()
        bounds.append((t0, t1))
        tokens = sum(n for t, n in rec.arrivals if t0 < t <= t1)
        rows.append({"traced": tracer.enabled, "seconds": t1 - t0,
                     "tokens_per_s": tokens / (t1 - t0)})
        log(f"window {i}: {rows[-1]}")
    c1 = _counters(b)
    traced = [w for w, r in zip(bounds, rows) if r["traced"]]
    readings = host_readings([r.req for r in rec.by_rid.values()],
                             tracer.events, traced, bounds[0][0],
                             bounds[-1][1], c0, c1)
    tracer.enabled = True
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    s0 = _counters(b)["serving.steps"]
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_ROUNDS):
            loop.round(ramp)
        sync()
        wall = time.perf_counter() - t0
    tracer.enabled = False
    steps = _counters(b)["serving.steps"] - s0
    counts = launch_counts(prof.events())
    readings.update(device_readings(counts, steps))
    rate = {}
    for k in (False, True):
        got = [r["tokens_per_s"] for r in rows if r["traced"] == k]
        rate[k] = statistics.median(got) if got else None
    return {"workload": plan.workload["name"], "seed": seed,
            "device": {"kind": (torch.cuda.get_device_name(0) if on_card
                                else device)},
            "windows": rows,
            "tokens_per_s": {"untraced": rate[False],
                             "traced": rate[True]},
            "metrics": readings,
            "segment": dict(counts, rounds=PROFILE_ROUNDS, steps=steps,
                            wall_s=wall, dropped_events=tracer.dropped)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--windows", type=int, default=4)
    args = ap.parse_args(argv)
    # import the harness as the package ``perfbench``, as run.py does
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import harness

    plan = harness.load_plan(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("[serving_trace] needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = run(plan, args.seed, args.seconds, args.windows,
              log=lambda m: print(f"[serving_trace] {m}", file=sys.stderr,
                                  flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
