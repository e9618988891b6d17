"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the program (``src/repro_torch``), draws the cell's weights and
traffic from ``--seed``, warms up, measures ``--seconds``, judges what the
window served against the plain reference, and prints one JSON object as
the last line of standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``.  The numbers
compared, each beside its limit, are also the last lines of standard
error.  Needs a CUDA device; without one it exits with code 2 and prints
no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # import the harness as the package ``perfbench``, never its files as
    # top-level modules
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # the program's library may pull in optional frameworks; keep them off
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from perfbench import harness

    plan = harness.load_plan(args.workload, ROOT)
    import torch

    chips = int(plan.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import repro_torch  # noqa: F401  (fails here outside a checkout)

    torch.set_num_threads(2)
    result = harness.run(plan, args.seed, args.seconds, bool(args.trace),
                         T_START, log=_log)
    result.pop("verdict")
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        _log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        _log(f"check {name}: {c['value']} (limit {c['limit']})")
    _log(f"correct: {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
