from .ops import sort_pairs, staged_merge
from .ref import sort_pairs_ref, staged_merge_ref

__all__ = ["sort_pairs", "staged_merge", "sort_pairs_ref",
           "staged_merge_ref"]
