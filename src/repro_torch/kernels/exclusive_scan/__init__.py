from .ops import csr_offsets, exclusive_scan
from .ref import exclusive_scan_ref

__all__ = ["exclusive_scan", "csr_offsets", "exclusive_scan_ref"]
