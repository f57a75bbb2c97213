from .ops import parse_accumulate, parse_bytes
from .ref import parse_accumulate_ref, parse_bytes_ref

__all__ = ["parse_bytes", "parse_bytes_ref", "parse_accumulate",
           "parse_accumulate_ref"]
