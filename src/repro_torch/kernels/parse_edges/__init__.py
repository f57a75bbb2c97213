from .ops import parse_bytes
from .ref import parse_bytes_ref

__all__ = ["parse_bytes", "parse_bytes_ref"]
