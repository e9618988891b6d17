from . import ops, ref
from .kernel import rmsnorm_kernel
from .ops import rmsnorm

__all__ = ["ops", "ref", "rmsnorm", "rmsnorm_kernel"]
