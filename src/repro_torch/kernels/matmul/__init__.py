from . import ops, ref
from .kernel import matmul_kernel
from .ops import matmul

__all__ = ["matmul", "matmul_kernel", "ops", "ref"]
