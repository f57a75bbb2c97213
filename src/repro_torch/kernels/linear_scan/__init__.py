from .ops import linear_scan, linear_scan_op
from .ref import linear_scan_loop, linear_scan_ref

__all__ = ["linear_scan", "linear_scan_op", "linear_scan_ref",
           "linear_scan_loop"]
