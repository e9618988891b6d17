"""The port's continuous batcher against the JAX package's on the CPU, at
f32, plus the guards: config rules, unported modes, the device default,
and the rule that the port imports nothing of ``jax`` or ``repro``.
(``generate`` and the engine steps: ``tests/test_torch_engine.py``.)

Greedy tokens must be identical to the reference's; weights come from
``repro.models.init_params`` through ``weights.params_from_jax``.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.serving import ServingConfig as JaxServingConfig
from repro_torch.configs import get_reduced
from repro_torch.serving import (
    ContinuousBatcher, Request, ServeConfig, ServingConfig, generate,
)
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
# the port's impl names beside the reference's
IMPL_PAIRS = [("torch", "xla"), ("cuda", "pallas")]


def _configs(window=None):
    jcfg = dataclasses.replace(jax_reduced("qwen3-0.6b"), dtype="float32",
                               sliding_window=window)
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), dtype="float32",
                              sliding_window=window)
    return jcfg, cfg


@pytest.fixture(scope="module")
def models():
    jcfg, _ = _configs()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


# ---------------------------------------------------------------------------
# continuous batcher
# ---------------------------------------------------------------------------


PROMPTS = [np.random.default_rng(3 + i).integers(1, 512, size=1 + i % 10)
           .astype(np.int32) for i in range(9)]


def _serve(make, Req, eos_map, chunk, impl, cfg, params):
    config_cls = ServingConfig if Req is Request else JaxServingConfig
    config = config_cls(slots=4, prompt_len=10, max_len=26, chunk=chunk,
                        attn_impl=impl)
    b = make(params, cfg, config)
    reqs = [Req(rid=i, prompt=p, max_new=6 + i % 5, eos=eos_map.get(i))
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        b.submit(r)
    b.run()
    return b, reqs


def _mid_chunk_eos(out):
    """A token of ``out`` whose first occurrence is a decode step past the
    first (index >= 2), so EOS on it fires inside a chunk."""
    for i in range(2, len(out) - 1):
        if out[i] not in out[:i]:
            return out[i]
    raise AssertionError(f"no usable EOS token in {out}")


def _port_batcher(params, cfg, config):
    return ContinuousBatcher(params, cfg, config, device="cpu")


@pytest.mark.parametrize("window", [None, 8], ids=["full", "window8-ring"])
@pytest.mark.parametrize("impl,jimpl", IMPL_PAIRS)
def test_batcher_matches_jax_with_eos_mid_chunk(models, impl, jimpl, window):
    """Mixed prompt lengths (left-padded to the bucket), admission in
    partial buckets, and an EOS that lands mid-chunk: every request's tokens
    equal the JAX batcher's, for chunk=8 and chunk=1 alike."""
    jp, params = models
    jcfg, cfg = _configs(window)
    _, probe = _serve(JaxBatcher, JaxRequest, {}, 8, jimpl, jcfg, jp)
    eos_map = {i: _mid_chunk_eos(probe[i].out) for i in (0, 5)}
    _, want = _serve(JaxBatcher, JaxRequest, eos_map, 8, jimpl, jcfg, jp)
    for i in (0, 5):                                   # EOS fired mid-chunk
        assert want[i].out[-1] == eos_map[i]
        assert 3 <= len(want[i].out) < want[i].max_new
    for chunk in (8, 1):
        b, got = _serve(_port_batcher, Request, eos_map, chunk, impl, cfg,
                        params)
        assert [r.out for r in got] == [r.out for r in want]
        assert all(r.done for r in got)


def test_batcher_stats_contract(models):
    """One dispatch and one host sync per admission and per chunk; chunk=8
    batches its decode dispatches."""
    _, params = models
    _, cfg = _configs()
    b8, reqs = _serve(_port_batcher, Request, {}, 8, "cuda", cfg, params)
    b1, _ = _serve(_port_batcher, Request, {}, 1, "cuda", cfg, params)
    for b in (b8, b1):
        s = b.stats
        assert s.dispatches == s.prefills + s.chunks
        assert s.host_syncs == s.prefills + s.chunks
        assert s.completed == len(PROMPTS)
        assert s.tokens == sum(len(r.out) for r in reqs)
        assert s.admit_tokens == len(PROMPTS)
        assert s.cache_bytes == sum(
            t.numel() * t.element_size() for t in b.caches.kv["0"])
    assert b8.stats.chunks < b1.stats.chunks / 2
    assert b8.stats.registry.counter("serving.chunks").value == b8.stats.chunks


def test_batcher_tracer_spans(models):
    """With a tracer on, every round, admission, dispatch, host sync and
    chunk becomes a span on the tenant's track, and tokens are unchanged."""
    from repro_torch.obs import Telemetry, Tracer

    _, params = models
    _, cfg = _configs()

    def run(telemetry):
        b = ContinuousBatcher(params, cfg, ServingConfig(
            slots=4, prompt_len=10, max_len=26), device="cpu",
            telemetry=telemetry)
        reqs = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(PROMPTS)]
        for r in reqs:
            b.submit(r)
        b.run()
        return b, [r.out for r in reqs]

    tel = Telemetry(tracer=Tracer(), tenant="t0")
    traced, outs = run(tel)
    _, plain = run(None)
    assert outs == plain
    names = [e["name"] for e in tel.tracer.to_chrome()["traceEvents"]
             if e.get("ph") == "X"]
    for span in ("round", "admission", "dispatch", "host_sync", "chunk"):
        assert span in names
    assert names.count("chunk") == traced.stats.chunks
    assert tel.registry.counter("serving.chunks", "t0").value == \
        traced.stats.chunks


def test_batcher_sheds_expired_deadlines(models):
    _, params = models
    _, cfg = _configs()
    now = [10.0]
    b = ContinuousBatcher(params, cfg, ServingConfig(slots=2, prompt_len=4,
                                                     max_len=12),
                          device="cpu", clock=lambda: now[0])
    late = Request(rid=0, prompt=PROMPTS[1][:4], max_new=3, deadline=5.0)
    ok = Request(rid=1, prompt=PROMPTS[2][:4], max_new=3, deadline=50.0)
    b.submit(late)
    b.submit(ok)
    b.run()
    assert late.dropped and late.done and not late.out
    assert ok.done and len(ok.out) == 3
    assert b.stats.deadline_drops == 1


def test_legacy_kwargs_shim_warns(models):
    _, params = models
    _, cfg = _configs()
    with pytest.warns(DeprecationWarning):
        b = ContinuousBatcher(params, cfg, slots=2, prompt_len=4, max_len=8,
                              device="cpu")
    assert b.config == ServingConfig(slots=2, prompt_len=4, max_len=8)
    with pytest.warns(DeprecationWarning), \
            pytest.raises(TypeError, match="did you mean"):
        ContinuousBatcher(params, cfg, slot=2, prompt_len=4, max_len=8,
                          device="cpu")


# ---------------------------------------------------------------------------
# ServingConfig: the same rules as the reference
# ---------------------------------------------------------------------------


BASE = dict(slots=4, prompt_len=8, max_len=16)
BAD_CONFIGS = {
    "slots=0": dict(slots=0),
    "prompt_len=0": dict(prompt_len=0),
    "max_len<=prompt_len": dict(max_len=8),
    "chunk=0": dict(chunk=0),
    "tp=0": dict(tp=0),
    "tp>1 with kernels": dict(tp=2, attn_impl="KERNEL"),
    "unknown impl": dict(attn_impl="flash"),
    "page_size=0": dict(paged=True, page_size=0, attn_impl="ORACLE"),
    "n_pages=0": dict(paged=True, n_pages=0, attn_impl="ORACLE"),
    "prefix without paged": dict(prefix_cache=True),
    "draft_window=1": dict(speculative=True, draft_window=1, attn_impl="ORACLE"),
    "draft_ngram=0": dict(speculative=True, draft_ngram=0, attn_impl="ORACLE"),
    "draft_hist small": dict(speculative=True, draft_hist=4, attn_impl="ORACLE"),
}


def _impl(kw, names):
    kw = dict(BASE, **kw)
    if kw.get("attn_impl") in names:
        kw["attn_impl"] = names[kw["attn_impl"]]
    return kw


@pytest.mark.parametrize("case", list(BAD_CONFIGS))
def test_serving_config_rejects_what_jax_rejects(case):
    kw = BAD_CONFIGS[case]
    with pytest.raises(ValueError):
        JaxServingConfig(**_impl(kw, {"KERNEL": "pallas", "ORACLE": "xla"}))
    with pytest.raises(ValueError):
        ServingConfig(**_impl(kw, {"KERNEL": "cuda", "ORACLE": "torch"}))


def test_serving_config_defaults_to_the_kernels():
    assert ServingConfig(**BASE).attn_impl == "cuda"
    assert ServeConfig(max_len=8).attn_impl == "cuda"


UNPORTED = {
    "paged": dict(paged=True),
    "prefix_cache": dict(paged=True, prefix_cache=True),
    "speculative": dict(speculative=True),
    "overlap": dict(overlap=True),
    "tp": dict(tp=2, attn_impl="torch"),
    "watchdog_s": dict(watchdog_s=1.0),
    "audit": dict(audit=True),
}


@pytest.mark.parametrize("mode", list(UNPORTED))
def test_unported_modes_raise_naming_roadmap(models, mode):
    _, params = models
    _, cfg = _configs()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        ContinuousBatcher(params, cfg, ServingConfig(**BASE, **UNPORTED[mode]),
                          device="cpu")


# ---------------------------------------------------------------------------
# entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------


def test_entry_points_without_device_raise_on_a_cpu_box(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    _, params = models
    _, cfg = _configs()
    prompts = np.ones((1, 4), np.int32)
    calls = [
        lambda: init_params(cfg),
        lambda: ContinuousBatcher(params, cfg, ServingConfig(**BASE)),
        lambda: generate(params, cfg, prompts, n_new=2),
        lambda: params_from_jax({"w": np.zeros(2, np.float32)}),
        lambda: serve.main(["--reduced", "--tenants", "1", "--requests", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--reduced", "--tenants", "2", "--requests", "3",
                       "--max-new", "4", "--prompt-len", "6",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("completed=3/3") == 2


# ---------------------------------------------------------------------------
# the port imports nothing of jax or repro
# ---------------------------------------------------------------------------


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


def test_port_sources_import_no_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_poisoned_slot_is_requeued_and_resumes(models):
    """The batcher requeues a request whose slot the NaN sentinel retired,
    keeping its tokens; re-admission re-seeds the slot's cache and the
    request finishes with the same tokens as an unpoisoned run."""
    _, params = models
    _, cfg = _configs()

    def run(poison):
        b = ContinuousBatcher(params, cfg, ServingConfig(
            slots=2, prompt_len=10, max_len=26, chunk=2), device="cpu")
        reqs = [Request(rid=i, prompt=PROMPTS[i][:4], max_new=6)
                for i in range(2)]
        for r in reqs:
            b.submit(r)
        b.step()
        if poison:
            b.caches.kv["0"].v[:, 0] = float("nan")
        b.run()
        return b, [r.out for r in reqs]

    clean_b, clean = run(False)
    b, outs = run(True)
    assert b.stats.poisoned_slots == 1
    assert b.stats.resumed_tokens_kept > 0
    assert outs == clean
