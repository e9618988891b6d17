"""A run end to end on the CPU at a small size: the result line's schema,
a cell added by files alone, and the refusals of ``run.py``."""

from __future__ import annotations

import json
import shutil
import sys
import time

import pytest
import torch

from perfbench import harness, run as run_cli
from perfbench.tests.small import small_plan

SEED = 2**31 + 977


def _run(plan, cfg, trace=False, seconds=1.5):
    torch.set_num_threads(1)
    return harness.run(plan, SEED, seconds, trace, time.perf_counter(),
                       device="cpu", model_cfg=cfg, log=lambda m: None)


def _schema(out, names):
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert isinstance(out["correct"], bool)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, m in out["metrics"].items():
        assert name in names
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("cell", ["qwen3-0.6b.shared-prefix",
                                  "dsmoe16b.long-prompt"])
def test_result_line(cell):
    plan, cfg = small_plan(cell)
    out = _run(plan, cfg)
    out.pop("verdict")
    _schema(out, [m["name"] for m in plan.end_to_end])
    assert set(out["metrics"]) == {m["name"] for m in plan.end_to_end}
    assert out["metrics"]["tpot_p95_ms"]["value"] > 0
    assert out["correct"] and out["checks"]["logit_gap"]["value"] == 0.0
    assert out["checks"]["tokens_off_counters"]["value"] == 0


def test_traced_result_line():
    plan, cfg = small_plan("qwen3-0.6b.shared-prefix")
    out = _run(plan, cfg, trace=True)
    out.pop("verdict")
    _schema(out, [m["name"] for m in plan.per_layer])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the counters' metrics are there; the device's need the card
    got = out["metrics"]
    assert got["prefix.hit_token_share"]["value"] == pytest.approx(75.0)
    assert 0 < got["kv.peak_page_share"]["value"] <= 100
    assert got["batcher.dispatches_per_token"]["value"] > 0
    assert got["batcher.ttft_p95_ms"]["value"] > 0
    assert "paged_decode_roofline" not in got


NEW_MIX = {"kind": "closed_loop",
           "serving": {"slots": 3, "prompt_len": 40, "max_len": 56,
                       "n_pages": 12},
           "prompt_len": [20, 40], "out_len": [3, 12], "ramp": 3,
           "warmup_rounds": 2, "check_tokens": 12, "check_requests": 2}
NEW_READER = '''"""Requests completed in the window: a reader added by a file."""


def read(run):
    return float(run.counters["completed"])
'''


def test_cell_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(root / "perfbench")
              for p in (root / "perfbench").rglob("*") if p.is_file()}
    bench = root / "perfbench"
    (bench / "traffic" / "tiny-chat.json").write_text(json.dumps(NEW_MIX))
    (bench / "metrics" / "batcher.completed.py").write_text(NEW_READER)
    (bench / "limits" / "qwen3-0.6b.tiny-chat.json").write_text(
        json.dumps({"logit_gap": {"limit": 0.02}}))
    manifest["workloads"].append(
        {"name": "qwen3-0.6b.tiny-chat", "config": "qwen3-0.6b",
         "traffic": "tiny-chat", "chips": 1, "why": "a test cell"})
    manifest["per_layer"].append(
        {"name": "batcher.completed", "unit": "requests", "better": "higher",
         "source": "program_counter", "layer": "batcher (serving/batcher.py)",
         "moves": "tokens_per_s", "workloads": ["qwen3-0.6b.tiny-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    after = {p.relative_to(bench) for p in bench.rglob("*") if p.is_file()}
    assert before <= after                  # nothing there was edited away
    for rel in before:
        assert (bench / rel).read_bytes() == (
            harness.ROOT / "perfbench" / rel).read_bytes()

    plan, cfg = small_plan("qwen3-0.6b.tiny-chat", root=root)
    assert plan.mix["serving"]["slots"] == 3
    assert [m["name"] for m in plan.per_layer] == ["batcher.completed"]
    out = _run(plan, cfg, trace=True)
    assert out["correct"]
    assert out["metrics"]["batcher.completed"]["value"] == out["attempted"]


def test_run_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_cli.main(["--workload", "dsmoe16b.long-prompt", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_run_fails_without_the_program(tmp_path, capsys, monkeypatch):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program to run: no result."""
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(run_cli, "ROOT", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    saved = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] == "repro_torch"}
    for k in saved:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setattr(sys, "path", [p for p in sys.path
                                      if not p.endswith("src")])
    with pytest.raises(ImportError):
        run_cli.main(["--workload", "dsmoe16b.long-prompt", "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    assert capsys.readouterr().out == ""
