from . import ops, ref
from .kernel import paged_decode_attention_kernel, paged_verify_attention_kernel
from .ops import paged_decode_attention, paged_verify_attention

__all__ = ["ops", "paged_decode_attention", "paged_decode_attention_kernel",
           "paged_verify_attention", "paged_verify_attention_kernel", "ref"]
