from . import ops, ref
from .kernel import flash_attention_kernel
from .ops import flash_attention

__all__ = ["flash_attention", "flash_attention_kernel", "ops", "ref"]
