"""One run of one cell: load the cell's files by name, build the program's
batcher on weights drawn from the seed, drive it as a closed loop, measure
a window, read the per-layer metrics from the counters and the profiler
trace, and judge what the window served against the plain reference.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic; ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<workload>.json`` hold them, and
``metrics/<metric>.py`` holds the reader of each per-layer metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from . import yardstick
from .traffic import gen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# steady rounds the profiler covers after the window with ``--trace 1``:
# the card's kernels alone, then the host's ops and ranges as well
TRACE_ROUNDS = 3
HOST_TRACE_ROUNDS = 2


class PlanError(ValueError):
    """A cell's files are missing or do not fit together."""


@dataclasses.dataclass
class Plan:
    workload: Dict
    conf: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    files: Dict[str, Path]


def _load_json(path: Path) -> Dict:
    if not path.is_file():
        raise PlanError(f"missing file {path}")
    return json.loads(path.read_text())


def load_plan(workload: str, root: Path = ROOT) -> Plan:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    manifest = _load_json(root / "BENCHMARK.json")
    bench = root / "perfbench"
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise PlanError(f"unknown workload {workload!r}; known: "
                        f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    files = {"config": root / configs[cell["config"]]["file"],
             "traffic": bench / "traffic" / f"{cell['traffic']}.json",
             "limits": bench / "limits" / f"{workload}.json"}

    def mine(metric):
        return workload in metric.get("workloads", cells)

    per_layer = [m for m in manifest["per_layer"] if mine(m)]
    for m in per_layer:
        files["metric:" + m["name"]] = bench / "metrics" / f"{m['name']}.py"
        if not files["metric:" + m["name"]].is_file():
            raise PlanError(f"no reader {files['metric:' + m['name']]}")
    return Plan(workload=cell, conf=_load_json(files["config"]),
                mix=_load_json(files["traffic"]),
                limits=_load_json(files["limits"]),
                end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
                per_layer=per_layer, files=files)


def load_reader(path: Path):
    """The ``read(run)`` function of a metric reader file."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose top-level name, whole, is a JAX package or the
    JAX reference package (``repro_torch`` is not ``repro``)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# Recording around the batcher
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Req:
    spec: gen.Spec
    rid: int
    submit_t: float
    req: Any = None
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def n_prompt(self) -> int:
        return len(self.spec.prompt)


@dataclasses.dataclass
class Round:
    index: int
    admissions: List[tuple] = dataclasses.field(default_factory=list)
    chunks: List[tuple] = dataclasses.field(default_factory=list)


class Recorder:
    """Wraps the batcher's admission and chunk calls on the instance:
    records when each request's tokens reach the host, what each round
    admitted and decoded, and host spans (inside a profiler session, as
    ``perfbench.<span>`` ranges)."""

    def __init__(self, batcher, clock=time.perf_counter):
        import torch

        self._torch = torch
        self.b = batcher
        self.clock = clock
        self.by_rid: Dict[int, Req] = {}
        self.arrivals: List[tuple] = []       # (t, tokens)
        self.first_arrivals: List[tuple] = []  # (t, tokens) of admissions
        self.completed: List[Req] = []
        self.rounds: List[Round] = []
        self.ranges = False
        self._wrap()

    def _span(self, name):
        if self.ranges:
            return self._torch.profiler.record_function("perfbench." + name)
        return contextlib.nullcontext()

    def _timed_wait(self, rec):
        wait = rec["fetch"].wait

        def timed():
            with self._span("sync_wait"):
                return wait()
        rec["fetch"].wait = timed
        return rec

    def _wrap(self):
        b = self.b
        admit, dispatch_paged = b._admit, b._dispatch_paged
        finish_admit = b._finish_admit
        dispatch_chunk, finish_chunk = b._dispatch_chunk, b._finish_chunk

        def _admit(**kw):
            with self._span("admission"):
                return admit(**kw)

        def _dispatch_paged(group, k):
            ps, P = b.page_size, b.prompt_len
            rows = []
            for join in group:
                n_real = len(join["req"].prompt) + len(join["req"].out)
                cached = max(0, k * ps - (P - n_real))
                rows.append((join["req"].rid, n_real - cached, cached))
            self.rounds[-1].admissions.append((k, rows))
            return self._timed_wait(dispatch_paged(group, k))

        def _finish_admit(rec):
            out = finish_admit(rec)
            t = self.clock()
            n = 0
            for join in rec["joins"]:
                r = self.by_rid[join["req"].rid]
                if r.first_t is None:
                    r.first_t = t
                r.last_t = t
                n += 1
                if join["req"].done:
                    self._complete(r, t)
            self.arrivals.append((t, n))
            self.first_arrivals.append((t, n))
            return out

        def _dispatch_chunk(active):
            with self._span("dispatch"):
                pending = dispatch_chunk(active)
            pending["before"] = [(b.slot_req[i], len(b.slot_req[i].out))
                                 for i in active]
            return self._timed_wait(pending)

        def _finish_chunk(pending, **kw):
            with self._span("bookkeeping"):
                out = finish_chunk(pending, **kw)
            t = self.clock()
            rows, n = [], 0
            for req, n0 in pending["before"]:
                c = len(req.out) - n0
                r = self.by_rid[req.rid]
                rows.append((req.rid, n0, c))
                if c > 0:
                    r.last_t = t
                    n += c
                if req.done:
                    self._complete(r, t)
            self.rounds[-1].chunks.append((pending["T"], rows))
            self.arrivals.append((t, n))
            return out

        b._admit = _admit
        b._dispatch_paged = _dispatch_paged
        b._finish_admit = _finish_admit
        b._dispatch_chunk = _dispatch_chunk
        b._finish_chunk = _finish_chunk

    def _complete(self, r: Req, t: float):
        if r.done_t is None:
            r.done_t = t
            self.completed.append(r)

    def new_round(self):
        self.rounds.append(Round(len(self.rounds)))


# ---------------------------------------------------------------------------
# The closed loop
# ---------------------------------------------------------------------------


class Loop:
    """One client per slot, each sending its next request when its last
    completes; ``ramp`` clients join per round until all have."""

    def __init__(self, batcher, traffic, recorder: Recorder, request_cls):
        self.b = batcher
        self.traffic = traffic
        self.rec = recorder
        self.Request = request_cls
        self.started = 0
        self.next_rid = 0
        self.first_use = {}          # namespace -> rid of its first request

    def submit(self, client: int, t: float):
        spec = self.traffic.next(client)
        rid = self.next_rid
        self.next_rid += 1
        req = self.Request(rid=rid, prompt=spec.prompt, max_new=spec.max_new,
                           namespace=spec.namespace)
        r = Req(spec=spec, rid=rid, submit_t=t, req=req)
        self.rec.by_rid[rid] = r
        if spec.namespace is not None and spec.namespace not in self.first_use:
            self.first_use[spec.namespace] = rid
        self.b.submit(req)

    def round(self, ramp: int):
        self.rec.new_round()
        done_before = len(self.rec.completed)
        self.b.step()
        for r in self.rec.completed[done_before:]:
            self.submit(r.spec.client, r.done_t)
        if self.started < self.traffic.clients:
            t = self.rec.clock()
            for _ in range(min(ramp, self.traffic.clients - self.started)):
                self.submit(self.started, t)
                self.started += 1


# ---------------------------------------------------------------------------
# Profiler segments
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Segment:
    """A profiled run of whole rounds: kernel intervals (us, the
    profiler's clock), the host's perfbench spans and the kernels each MoE
    range launched, the wall seconds from a sync to a sync and the rounds
    it covered."""

    wall_s: float
    rounds: List[Round]
    kernels: List[tuple]
    host_spans: List[tuple] = dataclasses.field(default_factory=list)
    range_us: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        return union_us(self.kernels) * 1e-6

    def kernel_us(self, names) -> float:
        """Summed time of the kernels whose unqualified name is in
        ``names``."""
        return sum(e - s for n, s, e in self.kernels
                   if kernel_base(n).split("::")[-1] in names)


def kernel_base(name: str) -> str:
    """A kernel's qualified name without return type, anonymous namespace,
    template arguments and parameters:
    ``void (anonymous namespace)::fa_mma_kernel<128>(...)`` ->
    ``fa_mma_kernel``."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[len("void "):]
    return n.split("(")[0].split("<")[0].strip() or name


def union_us(spans) -> float:
    """Length of the union of (name, start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _profile(loop: Loop, n_rounds: int, ramp: int, host: bool) -> Segment:
    """Profile ``n_rounds`` rounds: the card's kernels, and with ``host``
    the host's ops and ranges too (on the CPU, its ops only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = loop.b.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CUDA] if on_card else []
    if host or not on_card:
        acts.append(ProfilerActivity.CPU)
    sync()
    first = len(loop.rec.rounds)
    loop.rec.ranges = host
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            loop.round(ramp)
        sync()
        wall = time.perf_counter() - t0
    loop.rec.ranges = False
    cuda = torch.autograd.DeviceType.CUDA
    kernels, spans, ranges = [], [], {}
    for evt in prof.events():
        s, e = evt.time_range.start, evt.time_range.end
        if evt.device_type == cuda:
            if e > s and not evt.name.startswith(("moe.", "perfbench.")):
                kernels.append((evt.name, s, e))
            continue
        if evt.name.startswith("perfbench."):
            spans.append((evt.name[len("perfbench."):], s, e))
        elif evt.kernels:
            scope = evt.cpu_parent
            while scope is not None and not scope.name.startswith("moe."):
                scope = scope.cpu_parent
            if scope is not None:
                ranges[scope.name] = ranges.get(scope.name, 0.0) + sum(
                    k.duration for k in evt.kernels)
    return Segment(wall_s=wall, rounds=loop.rec.rounds[first:],
                   kernels=kernels, host_spans=spans, range_us=ranges)


def idle_gaps(seg: Segment) -> List[list]:
    """Idle device time between kernels, summed by the innermost host span
    the gap's midpoint fell in."""
    merged = []
    for _, s, e in sorted(seg.kernels, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    spans = sorted(seg.host_spans, key=lambda x: x[2] - x[1])
    by: Dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        name = next((n for n, s, e in spans if s <= mid <= e), "outside")
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])][:10]


def top_ops(seg: Segment) -> List[list]:
    by: Dict[str, float] = {}
    for n, s, e in seg.kernels:
        by[kernel_base(n)] = by.get(kernel_base(n), 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])][:10]


# ---------------------------------------------------------------------------
# What the per-layer readers see
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunView:
    conf: Dict
    mix: Dict
    dims: yardstick.Dims
    page_size: int
    n_pages: int
    window_s: float
    counters: Dict[str, int]           # window deltas of BatcherStats
    stats_end: Dict[str, int]
    work: yardstick.Work               # the work the window's traffic needed
    prompt_tokens: int                 # real prompt tokens admitted
    reqs: Dict[int, Req]
    ttft: List[float]                  # seconds, every first token inside
    tpot: List[float]                  # seconds, every completion inside
    seg: Optional[Segment] = None      # device only: busy, kernels, rounds
    host_seg: Optional[Segment] = None  # with the host's ops and ranges


def window_work(rec: Recorder, rounds: List[Round], first_use: Dict) -> tuple:
    """(Work, real prompt tokens admitted) of ``rounds``: a request's real
    prompt tokens (no padding), less its tenant's shared prefix once the
    tenant's first request has brought it; each decode token with the real
    keys it attends to."""
    work = yardstick.Work()
    prompt = 0
    for rnd in rounds:
        for _, rows in rnd.admissions:
            for rid, n_new, cached in rows:
                r = rec.by_rid[rid]
                n_real = n_new + cached
                prompt += n_real
                ns = r.spec.namespace
                pre = (r.spec.prefix_len
                       if ns is not None and first_use.get(ns) != rid else 0)
                work.add_prompt(n_real - pre, pre)
        for _, rows in rnd.chunks:
            for rid, n0, c in rows:
                r = rec.by_rid[rid]
                for t in range(c):
                    work.add_decode(r.n_prompt + n0 + t)
    return work, prompt


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def window_e2e(rec: Recorder, t_open: float, t_close: float) -> tuple:
    """(tokens that reached the host in the window, TTFT of each request
    whose first token did, TPOT of each request that completed in it with
    more than one token, the requests completed in it)."""
    inside = lambda t: t is not None and t_open < t <= t_close  # noqa: E731
    tokens = sum(n for t, n in rec.arrivals if inside(t))
    ttft = [r.first_t - r.submit_t for r in rec.by_rid.values()
            if inside(r.first_t)]
    done = [r for r in rec.completed if inside(r.done_t)]
    tpot = [(r.last_t - r.first_t) / (len(r.req.out) - 1) for r in done
            if len(r.req.out) > 1]
    return tokens, ttft, tpot, done


def _counters(b) -> Dict[str, int]:
    return dict(b.stats.as_dict())


def tokens_off_counters(rec: Recorder, t_open: float, t_close: float,
                        counters: Dict[str, int]) -> int:
    """How far the tokens the wrapped batcher methods recorded in the
    window lie from the window's ``BatcherStats`` deltas, admissions' first
    tokens and decode tokens each: 0 while the wrappers see every token
    the batcher emits, and more once a change to the batcher routes tokens
    past them.  A request requeued with its tokens thrown away (a denied
    page) takes its last chunk's tokens out of the recorder's count but
    not out of ``decode_tokens``; those are within the discarded tokens,
    which are let off."""
    inside = lambda t: t_open < t <= t_close  # noqa: E731
    first = sum(n for t, n in rec.first_arrivals if inside(t))
    total = sum(n for t, n in rec.arrivals if inside(t))
    off = (abs(first - counters["admit_tokens"])
           + abs(total - first - counters["decode_tokens"]))
    return max(0, off - counters["oom_discarded_tokens"])


def judge(stats: Dict, tokens: int, limits: Dict, check_tokens: int,
          failed: int, off_counters: int = 0) -> tuple:
    """(correct, checks): each number compared beside its limit.  ``stats``
    is a :func:`perfbench.correct.summary` of the gaps at ``tokens`` served
    positions (the program's, or the control's on the same positions); the
    cell's ``limits`` name the statistic compared."""
    lg = limits["logit_gap"]
    checks = {"logit_gap": {"value": stats[lg.get("statistic", "gap")],
                            "limit": lg["limit"]},
              "served_tokens_checked": {"value": tokens,
                                        "limit": int(check_tokens) // 2},
              "requests_failed": {"value": failed, "limit": 0},
              "tokens_off_counters": {"value": off_counters, "limit": 0}}
    ok = (checks["logit_gap"]["value"] <= checks["logit_gap"]["limit"]
          and tokens >= checks["served_tokens_checked"]["limit"]
          and tokens > 0 and failed == 0 and off_counters == 0)
    return bool(ok), checks


def check_program(cfg, conf: Dict) -> None:
    """Refuse a run whose program model differs from the configuration
    file in a number the weights, the reference or the yardstick read."""
    m = yardstick.dims(conf)
    want = {"d_model": m.d_model, "n_layers": m.n_layers,
            "n_heads": m.n_heads, "n_kv_heads": m.n_kv_heads,
            "d_head": m.d_head, "vocab": m.vocab,
            "qk_norm": bool(conf.get("qk_norm")),
            "tie_embeddings": bool(conf.get("tie_word_embeddings")),
            "rope_theta": float(conf["rope_theta"]),
            "norm_eps": float(conf["rms_norm_eps"]), "dtype": conf["torch_dtype"]}
    have = {k: getattr(cfg, k) for k in want}
    if m.moe:
        mc = cfg.moe
        want.update(n_experts=m.n_experts, top_k=m.top_k,
                    expert_d_ff=m.expert_d_ff,
                    shared_ff=m.n_shared * m.expert_d_ff,
                    capacity_factor=float(conf["prefill_capacity_factor"]),
                    every=1)
        have.update(n_experts=mc.n_experts, top_k=mc.top_k,
                    expert_d_ff=mc.expert_d_ff,
                    shared_ff=mc.n_shared_experts * (mc.shared_d_ff
                                                     or mc.expert_d_ff),
                    capacity_factor=float(mc.capacity_factor), every=mc.every)
    else:
        want["d_ff"] = m.d_ff
        have["d_ff"] = cfg.d_ff
    diff = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if diff:
        raise PlanError(f"the program's model differs from the "
                        f"configuration file (program, file): {diff}")


def build(plan: Plan, seed: int, device: str, model_cfg=None):
    """The program's model config, the benchmark's weights and a batcher."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatcher, ServingConfig

    from . import weights as wmod

    cfg = model_cfg or get_config(plan.conf["program"]["arch"])
    check_program(cfg, plan.conf)
    params = wmod.make(plan.conf, seed, device)
    want = wmod.signature(params)
    have = wmod.signature(init_params(cfg, 0, device="meta"))
    if want != have:
        raise PlanError(f"the program's parameter tree differs from the "
                        f"benchmark's layout: {set(have) ^ set(want)}")
    serving = dict(plan.conf["program"]["serving"], **plan.mix["serving"])
    batcher = ContinuousBatcher(params, cfg, ServingConfig(**serving),
                                device=device)
    return cfg, params, batcher, serving


def run(plan: Plan, seed: int, seconds: float, trace: bool, t0: float, *,
        device: str = "cuda", model_cfg=None, log=print,
        control: bool = False) -> Dict:
    """One run of a cell; returns the result line's object.  ``control``
    also reads the float8 control on the same sample.  ``out["verdict"]``
    holds every reading of the comparison (the readings
    :mod:`perfbench.calibrate` sets the limits from); the result line
    leaves it out."""
    import torch

    from repro_torch.serving import Request

    from . import correct

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    m = yardstick.dims(plan.conf)
    marks = [("imports", time.perf_counter())]
    cfg, params, b, serving = build(plan, seed, device, model_cfg)
    marks.append(("weights and batcher", time.perf_counter()))
    if on_card:
        from repro_torch.kernels import _build
        _build.load_library()
        marks.append(("kernel library", time.perf_counter()))
    traffic = gen.make(plan.mix, seed, m.vocab)
    rec = Recorder(b)
    loop = Loop(b, traffic, rec, Request)
    ramp = int(plan.mix.get("ramp", traffic.clients))
    for _ in range(int(plan.mix["warmup_rounds"])):
        loop.round(ramp)
    if loop.started < traffic.clients:
        raise PlanError("warm-up ended before every client started: raise "
                        "warmup_rounds or ramp")
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    t_open = time.perf_counter()
    setup_s = t_open - t0
    marks.append(("warm-up", t_open))
    prev = t0
    parts = []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log("setup: " + ", ".join(parts) + " s")
    c0 = _counters(b)
    first_round = len(rec.rounds)
    while True:
        loop.round(ramp)
        if time.perf_counter() - t_open >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    t_close = time.perf_counter()
    window_s = t_close - t_open
    c1 = _counters(b)
    last_round = len(rec.rounds)
    seg = host_seg = None
    if trace:
        # steady rounds right after the window: the profiler's own
        # post-processing then stays out of the window's time
        seg = _profile(loop, TRACE_ROUNDS, ramp, host=False)
        host_seg = _profile(loop, HOST_TRACE_ROUNDS, ramp, host=True)
    counters = {k: c1[k] - c0[k] for k in c1}
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    reqs = rec.by_rid
    tokens, ttft, tpot, done = window_e2e(rec, t_open, t_close)
    off_counters = tokens_off_counters(rec, t_open, t_close, counters)
    failed = [r for r in done
              if len(r.req.out) != r.spec.max_new or r.req.dropped]
    log(f"window {window_s:.3f} s: {tokens} tokens, {len(ttft)} first "
        f"tokens, {len(done)} completed ({len(tpot)} with a TPOT), "
        f"{counters['steps']} decode steps, {counters['prefills']} "
        f"admissions; setup {setup_s:.3f} s")

    metrics: Dict[str, Dict] = {}
    if not trace:
        e2e = {"tokens_per_s": tokens / window_s,
               "ttft_p95_ms": 1e3 * yardstick.percentile(ttft, 0.95),
               "tpot_p95_ms": 1e3 * yardstick.percentile(tpot, 0.95),
               "setup_s": setup_s}
        for mdef in plan.end_to_end:
            metrics[mdef["name"]] = {"value": e2e[mdef["name"]],
                                     "unit": mdef["unit"]}
        log(f"tail samples: ttft {len(ttft)}, tpot {len(tpot)}")
    else:
        work, prompt = window_work(rec, rec.rounds[first_round:last_round],
                                   loop.first_use)
        view = RunView(conf=plan.conf, mix=plan.mix, dims=m,
                       page_size=int(serving["page_size"]),
                       n_pages=b.n_pages, window_s=window_s,
                       counters=counters, stats_end=c1, work=work,
                       prompt_tokens=prompt, reqs=reqs, ttft=ttft,
                       tpot=tpot, seg=seg,
                       host_seg=host_seg)
        for mdef in plan.per_layer:
            value = load_reader(plan.files["metric:" + mdef["name"]])(view)
            if value is not None:
                metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}

    # the window has closed: free the program, then judge what it served
    sample = correct.sample(done, plan.mix, seed)
    del b, params, loop, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    verdict = correct.readings(plan.conf, sample, seed, device,
                               int(serving["prompt_len"]), control=control)
    log(f"reference: {len(sample)} requests, {verdict['tokens']} served "
        f"tokens, widest gap {verdict['gap']:.6g}, mean "
        f"{verdict.get('mean', float('nan')):.6g}, "
        f"{time.perf_counter() - t_ref:.1f} s")
    ok, checks = judge(verdict, verdict["tokens"], plan.limits,
                       plan.mix["check_tokens"], len(failed), off_counters)
    out = {"correct": bool(ok), "attempted": len(done),
           "failed": len(failed), "metrics": metrics,
           "device": {"platform": "gpu" if on_card else device,
                      "kind": (torch.cuda.get_device_name(0) if on_card
                               else device),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and seg is not None:
        out["device"]["busy_s"] = seg.busy_s
        out["device"]["window_s"] = seg.wall_s
        out["breakdown"] = {"device_ops": top_ops(seg),
                            "idle_gaps": idle_gaps(host_seg)}
    out["verdict"] = verdict
    out["checks"] = checks
    return out
