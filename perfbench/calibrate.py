"""Readings that a cell's correctness limit is set from, in one process:

    python3 perfbench/calibrate.py --workload <name> --seeds 11,12,... \
        --seconds <s> [--control 3]

For each seed: a run of the cell at its own size and load (weights and
traffic from the seed, warm-up, a window of ``--seconds``), judged as a run
judges it, then, on the first ``--control`` seeds, the control: the same
reference in float8, the gap of the token float8 puts first at each of the
same positions, put through the same verdict (:func:`harness.judge`) in
the program's place.  Every reading is of the statistic the cell's
``limits/<cell>.json`` compares.  One JSON line a seed, then a summary: the
lower reading (the largest sound one), the upper reading (the smallest
control one), their ratio, and how many sound runs came out correct and
how many controls did not.  The benchmark's runs never run this; it needs
a CUDA device, as a run does.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def calibrate(plan, seeds, seconds, n_control, log=lambda m: None,
              **run_kw):
    """One line a seed and the summary; ``run_kw`` goes to
    :func:`harness.run` (the CPU tests' device and small model)."""
    import torch

    from perfbench import correct, harness

    lim = plan.limits["logit_gap"]
    stat = lim.get("statistic", "gap")
    lines = []
    for i, seed in enumerate(seeds):
        on_card = torch.cuda.is_available()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        out = harness.run(plan, seed, seconds, False, time.perf_counter(),
                          log=log, control=i < n_control, **run_kw)
        v = out["verdict"]
        line = {"seed": seed, "statistic": stat, "reading": v[stat],
                "correct": out["correct"], "checks": out["checks"],
                "stats": {k: v[k] for k in correct.STATISTICS},
                "failed": out["failed"],
                "metrics": {k: m["value"] for k, m in out["metrics"].items()},
                "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        if v["control"] is not None:
            ok, checks = harness.judge(v["control"], v["tokens"],
                                       plan.limits, plan.mix["check_tokens"],
                                       failed=0)
            line.update(control_reading=v["control"][stat],
                        control_correct=ok, control_stats=v["control"])
        lines.append(line)
        print(json.dumps(line), flush=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    sound = [x["reading"] for x in lines]
    ctrls = [x["control_reading"] for x in lines if "control_reading" in x]
    lower = max(sound)
    upper = min(ctrls) if ctrls else None
    summary = {"workload": plan.workload["name"], "statistic": stat,
               "limit": lim["limit"], "seeds": len(lines), "lower": lower,
               "upper": upper,
               "ratio": upper / lower if upper is not None and lower > 0
               else None,
               "sound_correct": sum(x["correct"] for x in lines),
               "controls": len(ctrls),
               "controls_not_correct": sum(
                   not x["control_correct"] for x in lines
                   if "control_correct" in x)}
    print(json.dumps({"summary": summary}), flush=True)
    return lines, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA device", file=sys.stderr)
        return 2
    plan = harness.load_plan(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    calibrate(plan, seeds, args.seconds, args.control,
              log=lambda m: print(f"[calibrate] {m}", file=sys.stderr,
                                  flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
