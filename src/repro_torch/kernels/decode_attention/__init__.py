from . import ops, ref
from .kernel import decode_attention_kernel
from .ops import decode_attention

__all__ = ["decode_attention", "decode_attention_kernel", "ops", "ref"]
