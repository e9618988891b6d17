"""PyTorch model zoo: nested-dict parameter trees, stacked blocks, the
pure-attention dense-MLP families (the others arrive in later slices)."""

from .transformer import (
    Caches,
    LayerSpec,
    decode_step,
    init_caches,
    init_params,
    logits_fn,
    n_blocks,
    period_len,
    period_structure,
    prefill,
)

__all__ = [
    "Caches", "LayerSpec", "decode_step", "init_caches", "init_params",
    "logits_fn", "n_blocks", "period_len", "period_structure", "prefill",
]
