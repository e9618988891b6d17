from . import ops, ref
from .kernel import matmul_kernel, matmul_route
from .ops import matmul

__all__ = ["matmul", "matmul_kernel", "matmul_route", "ops", "ref"]
