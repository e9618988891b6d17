"""BENCHMARK.json against the rules its format keeps (names, units, bounds,
keys of each entry), and every cell's files found by name."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_KEYS = ("hidden", "intermediate", "head", "latent", "state",
              "num_experts_per_tok", "expansion")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_entries():
    seen = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("perfbench/")
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not any(w in key for w in WIDTH_KEYS), key
            assert not key.endswith(("_dim", "_rank")), key
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert [m["name"] for m in MANIFEST["end_to_end"]] == [
        "tokens_per_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"]
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_moves_is_reported_where_listed():
    e2e = {m["name"]: set(m.get("workloads", CELLS))
           for m in MANIFEST["end_to_end"]}
    for cell in CELLS:
        assert "setup_s" in {n for n, ws in e2e.items() if cell in ws}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m["workloads"]) <= e2e[m["moves"]]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    plan = harness.load_plan(cell)
    assert plan.files["config"].is_file()
    assert plan.files["traffic"].is_file()
    assert "limit" in plan.limits["logit_gap"]
    assert plan.per_layer, "every cell reports a per-layer metric"
    for m in plan.per_layer:
        assert callable(harness.load_reader(plan.files["metric:" + m["name"]]))
    conf = plan.conf
    assert conf["name"] == plan.workload["config"]
    entry = {c["name"]: c for c in MANIFEST["configs"]}[conf["name"]]
    assert conf["reduced"] == entry["reduced"]
    assert conf["source"].startswith(entry["source"])


@pytest.mark.parametrize("cell", CELLS)
def test_program_model_matches_configuration(cell):
    from repro_torch.configs import get_config

    plan = harness.load_plan(cell)
    harness.check_program(get_config(plan.conf["program"]["arch"]), plan.conf)


def test_program_model_mismatch_is_refused():
    import dataclasses

    from repro_torch.configs import get_config

    plan = harness.load_plan("qwen3-0.6b.unshared")
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), d_ff=2048)
    with pytest.raises(harness.PlanError, match="d_ff"):
        harness.check_program(cfg, plan.conf)


def test_unknown_workload():
    with pytest.raises(harness.PlanError, match="unknown workload"):
        harness.load_plan("no-such-cell")


@pytest.mark.parametrize("cell", CELLS)
def test_limit_sits_between_its_readings(cell):
    """Each limit lies above the largest sound reading and below the
    smallest control reading it was set from, which is three times the
    sound one or more."""
    lg = harness.load_plan(cell).limits["logit_gap"]
    assert lg["lower"] < lg["limit"] < lg["upper"]
    assert lg["upper"] >= 3 * lg["lower"]
    assert lg["sound_seeds"] >= 12 and lg["control_seeds"] >= 3
