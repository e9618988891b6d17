"""The serving loop's own tracing on the CPU: the batcher's spans on its one
clock and in the profiler's timeline, the model calls of every decode
chunk in ``serving.decode_model``, each request's stamps, and the
admission counters of computed and padding tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_train_parity import one_torch_thread  # noqa: F401 (a module fixture)

from repro_torch.configs import get_reduced
from repro_torch.models import init_params
from repro_torch.obs import Telemetry, Tracer
from repro_torch.serving import ContinuousBatcher, Request, ServingConfig

SPANS = ("round", "admission", "dispatch", "host_sync", "bookkeeping")
MODES = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=4, n_pages=20),
    "prefix": dict(paged=True, page_size=4, prefix_cache=True),
    "spec": dict(speculative=True, draft_window=3),
    "paged-spec": dict(paged=True, page_size=4, speculative=True,
                       draft_window=3),
    "overlap": dict(paged=True, page_size=4, overlap=True),
}


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def _prompts(n, seed=7):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 500, size=6).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, 500, size=2 + i % 5)])
            .astype(np.int32) for i in range(n)]


def _serve(model, mode, *, telemetry=None, clock=None, n=9):
    cfg, params = model
    b = ContinuousBatcher(params, cfg, ServingConfig(
        slots=4, prompt_len=12, max_len=24, attn_impl="torch",
        **MODES[mode]), device="cpu", telemetry=telemetry, clock=clock)
    reqs = [Request(rid=i, prompt=p, max_new=3 + i % 6, namespace="a")
            for i, p in enumerate(_prompts(n))]
    for r in reqs:
        b.submit(r)
    b.run()
    return b, reqs


def _scope(evt, prefix="serving."):
    """Names of the ``prefix`` ranges enclosing ``evt``, innermost first."""
    out, p = [], evt.cpu_parent
    while p is not None:
        if p.name.startswith(prefix):
            out.append(p.name)
        p = p.cpu_parent
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_equal_with_tracing_on_off_and_profiled(model, mode):
    """Tracing and a profiler change no token, and the profiled run shows
    every span of the batcher as a ``serving.`` range, each model call of
    a chunk inside ``serving.decode_model`` inside ``serving.dispatch``,
    and one ``serving.dispatch`` a chunk."""
    _, plain = _serve(model, mode)
    _, traced = _serve(model, mode, telemetry=Telemetry(tracer=Tracer()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b, profiled_reqs = _serve(model, mode,
                                  telemetry=Telemetry(tracer=Tracer()))
    want = [r.out for r in plain]
    assert [r.out for r in traced] == want
    assert [r.out for r in profiled_reqs] == want
    events = prof.events()
    names = [e.name for e in events]
    for span in SPANS:
        assert "serving." + span in names, span
    assert names.count("serving.dispatch") == b.stats.chunks
    models = [e for e in events if e.name == "serving.decode_model"]
    assert len(models) == b.stats.steps // (3 if "spec" in mode else 1)
    for e in models:
        assert _scope(e)[0] == "serving.dispatch"
    # the model's ops are in the range; token selection is bookkeeping
    assert any("serving.decode_model" in _scope(e) for e in events
               if e.name == "aten::mm")
    assert any(_scope(e)[:1] == ["serving.dispatch"] for e in events
               if e.name in ("aten::argmax", "aten::where"))


def test_no_serving_range_without_an_enabled_tracer(model):
    """A profiler session that did not turn tracing on records the events
    it recorded before: no ``serving.`` range."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, "paged")
    assert not [e for e in prof.events() if e.name.startswith("serving.")]


def test_every_batcher_span_is_on_the_batcher_clock(model):
    """With a tracer on a clock of its own, every span of the batcher is
    timed on the batcher's clock: the round and admission spans of
    ``step`` too."""
    ticks = iter(range(1, 10**6))
    reads = []

    def clock():
        reads.append(float(next(ticks)))
        return reads[-1]

    tracer = Tracer(clock=lambda: 1e9)
    b, _ = _serve(model, "overlap", telemetry=Telemetry(tracer=tracer),
                  clock=clock)
    spans = [e for e in tracer.events if e["ph"] == "X"]
    assert {e["name"] for e in spans} == set(SPANS) | {"chunk"}
    for e in spans:
        assert 1 <= e["ts"] <= e["ts"] + e["dur"] <= reads[-1], e


@pytest.mark.parametrize("mode", ["dense", "paged", "overlap"])
def test_untraced_batcher_reads_the_clock_for_the_stamps_only(model, mode):
    """Tracing off: one clock read a submit, two an admission record
    (``t_admit``, ``t_first``) and the two a chunk read already (its start
    and its sync, for the watchdog), which ``t_done`` shares."""
    n = [0]

    def clock():
        n[0] += 1
        return float(n[0])

    b, reqs = _serve(model, mode, clock=clock)
    s = b.stats
    assert n[0] == len(reqs) + 2 * s.prefills + 2 * s.chunks


@pytest.mark.parametrize("mode", sorted(MODES))
def test_request_stamps_are_ordered(model, mode):
    _, reqs = _serve(model, mode)
    for r in reqs:
        assert r.done and not r.dropped
        assert r.t_submit <= r.t_admit <= r.t_first <= r.t_done, r


def test_requeued_request_keeps_its_first_stamps(model):
    """A pool too small for every slot's growth denies pages and requeues
    requests; each keeps its first admission and first-token stamps."""
    cfg, params = model
    now = [0.0]

    def clock():
        now[0] += 1.0
        return now[0]

    b = ContinuousBatcher(params, cfg, ServingConfig(
        slots=4, prompt_len=8, max_len=24, attn_impl="torch", paged=True,
        page_size=4, n_pages=10, reserve_pages=False), device="cpu",
        clock=clock)
    reqs = [Request(rid=i, prompt=p[:8], max_new=14)
            for i, p in enumerate(_prompts(6))]
    firsts = {}
    finish = b._finish_admit

    def spy(rec):
        finish(rec)
        for join in rec["joins"]:
            firsts.setdefault(join["req"].rid, join["req"].t_first)

    b._finish_admit = spy
    for r in reqs:
        b.submit(r)
    b.run()
    assert b.stats.oom_requeues > 0
    for r in reqs:
        assert r.t_first == firsts[r.rid]
        assert r.t_submit <= r.t_admit <= r.t_first <= r.t_done


def _admit_counts(b):
    reg = b.telemetry.registry
    return (reg.counter("serving.admit_computed_tokens").value,
            reg.counter("serving.admit_pad_tokens").value)


def test_admission_counts_computed_and_padding_tokens(model):
    """Hand counts.  Dense: prompts of 3, 5 and 10 tokens in a bucket of 4
    rows of 10: 40 computed, 7 + 5 + 0 left padding + a duplicate row of
    10.  Paged cold, 2 rows of 16: 9 + 9 padding.  Cached suffix: 3 rows
    of 7 tokens over 2 cached pages of padding, a bucket of 4 rows of the
    8 suffix tokens: 1 padding token a real row + the duplicate row."""
    cfg, params = model
    rng = np.random.default_rng(0)
    b = ContinuousBatcher(params, cfg, ServingConfig(
        slots=4, prompt_len=10, max_len=16, attn_impl="torch"),
        device="cpu")
    for i, n in enumerate((3, 5, 10)):
        b.submit(Request(rid=i, prompt=rng.integers(1, 500, size=n)
                         .astype(np.int32), max_new=2))
    b.step()
    assert b.stats.prefills == 1
    assert _admit_counts(b) == (40, 22)

    b = ContinuousBatcher(params, cfg, ServingConfig(
        slots=4, prompt_len=16, max_len=24, attn_impl="torch", paged=True,
        page_size=4, prefix_cache=True), device="cpu")

    def req(i):
        return Request(rid=i, prompt=rng.integers(1, 500, size=7)
                       .astype(np.int32), max_new=3, namespace="a")

    for i in range(2):
        b.submit(req(i))
    b.step()
    assert b.stats.prefills == 1 and b.stats.prefix_hits == 0
    assert _admit_counts(b) == (32, 18)
    for i in range(2, 5):
        b.submit(req(i))
    b.run()
    assert b.stats.prefills == 2
    assert b.stats.prefill_tokens_skipped == 3 * 8       # 2 pages each
    assert _admit_counts(b) == (32 + 32, 18 + 3 * 1 + 8)
    # the reference's counter set is untouched
    assert "admit_pad_tokens" not in b.stats.as_dict()
