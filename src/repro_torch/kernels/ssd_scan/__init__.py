from . import ops, ref
from .kernel import ssd_route, ssd_scan_kernel
from .ops import ssd

__all__ = ["ops", "ref", "ssd", "ssd_route", "ssd_scan_kernel"]
