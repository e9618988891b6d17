"""PyTorch model zoo: nested-dict parameter trees, stacked blocks, the
pure-attention families (dense MLP or Mixture-of-Experts) and the SSM
(Mamba-2) family (hybrid, VLM and audio arrive in later slices)."""

from .transformer import (
    Caches,
    LayerSpec,
    decode_step,
    init_caches,
    init_paged_caches,
    init_params,
    logits_fn,
    n_blocks,
    period_len,
    period_structure,
    prefill,
    prefix_prefill,
    verify_step,
)
from .ssm import SSMState, init_ssm_state, ssm_decode, ssm_forward

__all__ = [
    "Caches", "LayerSpec", "decode_step", "init_caches", "init_paged_caches",
    "init_params", "logits_fn", "n_blocks", "period_len", "period_structure",
    "prefill", "prefix_prefill", "SSMState", "init_ssm_state", "ssm_decode",
    "ssm_forward", "verify_step",
]
