from .ops import degree_histogram
from .ref import degree_histogram_ref

__all__ = ["degree_histogram", "degree_histogram_ref"]
