"""No JAX and no JAX reference package in a run; the plain reference
imports nothing of the program.  Names compare whole at the top level:
``repro_torch`` (the program) is not ``repro`` (the JAX package)."""

from __future__ import annotations

import ast
import subprocess
import sys

from perfbench import harness


def test_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serving.batcher", "numpy", "jaxtyping",
         "reproducible", "flaxen.x", "perfbench.harness"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.models", "jax", "jax.numpy", "jaxlib.xla_client",
         "flax.linen", "numpy"]) == ["flax.linen", "jax", "jax.numpy",
                                     "jaxlib.xla_client", "repro",
                                     "repro.models"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = list((harness.HERE / "reference").glob("*.py")) + [
        harness.HERE / "weights.py", harness.HERE / "yardstick.py",
        harness.HERE / "correct.py"]
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("repro_torch", "repro", "jax", "jaxlib",
                               "flax"), (f.name, name)


def test_no_file_of_the_benchmark_imports_jax():
    for f in harness.HERE.rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "repro"), (f, name)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, time\n"
        "from perfbench import harness\n"
        "from perfbench.tests.small import small_plan\n"
        "plan, cfg = small_plan('dsmoe16b.long-prompt')\n"
        "out = harness.run(plan, 5, 1.0, False, time.perf_counter(),\n"
        "                  device='cpu', model_cfg=cfg, log=lambda m: None)\n"
        "assert out['correct'], out\n"
        "bad = harness.forbidden_modules(sys.modules)\n"
        "assert 'repro_torch' in sys.modules and not bad, bad\n"
        "print('clean')\n")
    env_path = [str(harness.ROOT / "src"), str(harness.ROOT)]
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=str(harness.ROOT),
        env={"PYTHONPATH": ":".join(env_path), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr[-2000:]
