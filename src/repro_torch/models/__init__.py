"""PyTorch model zoo: nested-dict parameter trees, stacked blocks, every
family of the reference: pure attention (dense MLP or Mixture-of-Experts),
SSM (Mamba-2), hybrid (Jamba), VLM (Qwen2-VL) and audio (Whisper); the
serving entry points and the training forward and chunked loss."""

from .transformer import (
    Caches,
    FwdOut,
    LayerSpec,
    decode_step,
    encoder_forward,
    forward,
    init_caches,
    init_paged_caches,
    init_params,
    lm_loss,
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
    "Caches", "FwdOut", "LayerSpec", "decode_step", "encoder_forward",
    "forward", "init_caches", "init_paged_caches",
    "init_params", "lm_loss", "logits_fn", "n_blocks", "period_len", "period_structure",
    "prefill", "prefix_prefill", "SSMState", "init_ssm_state", "ssm_decode",
    "ssm_forward", "verify_step",
]
