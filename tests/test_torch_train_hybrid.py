"""The port's train step against the JAX package's on the CPU, at f32, for
audio (whisper-base: the encoder over the stub frames and the decoder's
cross-attention, which the reference runs on its chunked route for
"flash") and the hybrid (jamba: SSM, MoE and attention layers in one
period), under "torch" and, under remat="full", "flash".  Tolerances as
stated in ``test_torch_train_parity.py``.
"""

import jax
import pytest

from test_torch_train_parity import (  # noqa: F401 (a module fixture)
    check_train_parity, one_torch_thread)

FAMILIES = ["whisper-base", "jamba-1.5-large-398b"]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_matches_jax(arch):
    """After 1 and 3 steps; for whisper also the gradients before the first
    update (jamba's reach the grad norm and the params; its JAX gradient
    program alone takes longer to compile than the rest of the file)."""
    _, _, m = check_train_parity(arch, steps=3, grads=arch == "whisper-base")
    if arch == "jamba-1.5-large-398b":
        assert float(m["aux"]) > 0.5           # the load-balance loss is live


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_flash_under_remat_matches_jax(arch):
    """The "flash" route under remat="full": through the non-causal encoder
    and the cross-attention (whisper, the latter on the chunked route as
    the reference sends it) and an SSM + MoE + attention period (jamba)."""
    check_train_parity(arch, impl="flash", steps=3, grads=False, remat="full")
