"""The comparison that decides ``correct``, on the CPU at a small size:
sound runs pass, the float8 control fails, and a run whose timed path is
broken underneath fails, once for each fault a serving cell can have.

Each cell compares the statistic its ``limits/<cell>.json`` names: the
widest gap (dense) or the mean gap over the sample's served tokens (MoE,
whose widest gap a single routing flip sets).  At this size the numbers
differ from the cells' own (their limits are set from chip runs at full
size); ``SMALL_LIMIT`` is this size's, set from readings on the CPU: bf16
runs of the program read a widest gap of 0.0006-0.0078 on the dense model
(float8: 0.079-0.125) and a mean gap of 0-0.0017 on the MoE small mix
(float8: 0.0094-0.0141), seeds 11-18.  A window's requests depend on the
CPU's speed, so the samples are large (16 requests on the dense model, 24
on the MoE) to keep these readings apart from run to run."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.reference import moe as ref_moe
from perfbench.tests.small import small_plan

SMALL_LIMIT = {"gap": 0.025, "mean": 0.004}
CELLS = ["qwen3-0.6b.unshared", "dsmoe16b.long-prompt"]


def _stat(cell):
    return harness.load_plan(cell).limits["logit_gap"].get("statistic",
                                                          "gap")


def _small(cell, dtype="float32"):
    """The cell's small plan, held to this size's limit."""
    plan, cfg = small_plan(cell, dtype)
    stat = _stat(cell)
    return dataclasses.replace(plan, limits={"logit_gap": {
        "limit": SMALL_LIMIT[stat], "statistic": stat}}), cfg


def _run(cell, seed, dtype="float32", control=False, seconds=2.5):
    torch.set_num_threads(1)
    plan, cfg = _small(cell, dtype)
    return harness.run(plan, seed, seconds, False, time.perf_counter(),
                       device="cpu", model_cfg=cfg, log=lambda m: None,
                       control=control), cfg


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_sound_runs_pass(cell):
    """The calibration tool's own verdicts: the sound bf16 runs come out
    correct and the float8 control, judged in the program's place by
    :func:`harness.judge`, does not, on every seed."""
    torch.set_num_threads(1)
    plan, cfg = _small(cell, "bfloat16")
    lines, summary = calibrate.calibrate(plan, (11, 12, 13), 2.5, 3,
                                         device="cpu", model_cfg=cfg)
    assert summary["statistic"] == _stat(cell)
    assert summary["sound_correct"] == 3, [x["checks"] for x in lines]
    assert summary["controls"] == 3 and summary["controls_not_correct"] == 3
    assert summary["lower"] < SMALL_LIMIT[_stat(cell)] < summary["upper"]
    assert summary["upper"] >= 3 * summary["lower"]
    for x in lines:
        assert x["reading"] == x["checks"]["logit_gap"]["value"]


def _alter_token(monkeypatch, cfg):
    from repro_torch.serving import engine

    real = engine.select_token
    monkeypatch.setattr(engine, "select_token", lambda *a, **k: (
        (real(*a, **k) + 1) % cfg.vocab).to(torch.int32))


def _state_unchanged(monkeypatch, cfg):
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_pool_write", lambda *a, **k: None)


def _half_batch(monkeypatch, cfg):
    from repro_torch.serving import engine

    real = engine.decode_step

    def half(*a, **k):
        logits, caches = real(*a, **k)
        B = logits.shape[0]
        h = B // 2
        logits = torch.cat([logits[:B - h], logits[:h]])
        return logits, caches
    monkeypatch.setattr(engine, "decode_step", half)


FAULTS = {"token altered": _alter_token, "state unchanged": _state_unchanged,
          "half the batch left out": _half_batch}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_correct_false(cell, fault, monkeypatch):
    _, cfg = small_plan(cell)
    FAULTS[fault](monkeypatch, cfg)
    out, _ = _run(cell, 21)
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] > SMALL_LIMIT[_stat(cell)]


def test_tokens_past_the_recorder_make_correct_false(monkeypatch):
    """A batcher whose round reaches its chunk through other calls than
    the instance's (as a restructured step would) emits tokens the
    recorder never sees: the counters' check fails the run."""
    from repro_torch.serving import ContinuousBatcher

    def step(self):
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if active:
            cls = type(self)
            cls._finish_chunk(self, cls._dispatch_chunk(self, active))
    monkeypatch.setattr(ContinuousBatcher, "step", step)
    out, _ = _run("qwen3-0.6b.unshared", 21)
    assert not out["correct"]
    assert out["checks"]["tokens_off_counters"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes(cell):
    out, _ = _run(cell, 21)
    assert out["correct"] and out["checks"]["logit_gap"]["value"] == 0.0
    assert out["checks"]["tokens_off_counters"]["value"] == 0


def test_capacity_rule_by_hand():
    # 5 tokens, top-2 of 3 experts, capacity 2: expert 0 is chosen by
    # tokens 0, 1, 3 (the third is dropped), expert 2 by 1, 2, 4
    top_i = torch.tensor([[0, 1], [2, 0], [2, 1], [0, 1], [1, 2]])
    keep = ref_moe._capacity_keep(top_i, 3, 2)
    assert keep.tolist() == [[True, True], [True, True], [True, True],
                             [False, False], [False, False]]
