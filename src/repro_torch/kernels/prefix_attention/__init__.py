from . import ops, ref
from .kernel import prefix_flash_attention_kernel
from .ops import prefix_flash_attention

__all__ = ["ops", "prefix_flash_attention", "prefix_flash_attention_kernel",
           "ref"]
