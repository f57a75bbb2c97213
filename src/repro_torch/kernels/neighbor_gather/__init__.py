from .ops import neighbor_gather
from .ref import neighbor_gather_ref

__all__ = ["neighbor_gather", "neighbor_gather_ref"]
