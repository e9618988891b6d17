"""The port's train step against the JAX package's on the CPU, at f32, for
the SSM (mamba2-370m: the chunked SSD scan under autograd), MoE
(deepseek-moe-16b: the grouped dispatch under autograd and the
load-balance aux loss) and the VLM (qwen2-vl-72b: patch embeddings and
(3, B, S) M-RoPE positions, split along axis 1 under gradient
accumulation) on the "torch" route.  The dense family is in ``test_torch_training.py``,
audio and the hybrid in ``test_torch_train_hybrid.py``.  Tolerances as stated in
``test_torch_train_parity.py``.
"""

import jax
import pytest

from test_torch_train_parity import (  # noqa: F401 (a module fixture)
    check_train_parity, one_torch_thread)

@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


# mamba2-370m has no attention layer: its three routes are one code path
# (``ssd_chunked``) in both packages.  "flash" and "naive" attention are
# held on qwen3-0.6b (test_torch_training.py), "flash" also on whisper-base
# and jamba (test_torch_train_hybrid.py).  deepseek-moe-16b and qwen2-vl-72b
# run with grad_accum=2: the VLM's positions split on axis 1, MoE's aux loss
# averaged over the microbatches.
@pytest.mark.parametrize("arch,tkw", [
    ("mamba2-370m", {}),
    ("deepseek-moe-16b", dict(grad_accum=2)),
    ("qwen2-vl-72b", dict(grad_accum=2)),
])
def test_family_train_step_matches_jax(arch, tkw):
    """After 1 and 3 steps, with the gradients of the whole batch before
    the first update."""
    _, _, m = check_train_parity(arch, steps=3, **tkw)
    if arch == "deepseek-moe-16b":
        assert float(m["aux"]) > 0.5           # the load-balance loss is live
