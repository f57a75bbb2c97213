"""Hand-written Hopper kernels for GVEL's hot spots, one package each.

Each package ships ``kernel.py`` (the ctypes launch of a CUDA source in
``repro_torch/csrc/``), ``ref.py`` (the plain PyTorch version) and
``ops.py`` (the wrapper: plain version for a CPU tensor, kernel for a CUDA
tensor, a launch count in ``_lib.LAUNCHES``).

  parse_edges       text blocks -> per-byte parsed edges (GVEL Alg. 1), and
                    the loader's fused parse + batch packing
  degree_histogram  vertex degrees (Alg. 2)
  exclusive_scan    degrees -> CSR offsets (Alg. 2 exclusiveScan)
  neighbor_gather   batched fixed-width CSR row reads (the CSR's consumers)
  linear_scan       h_t = a_t * h_{t-1} + b_t over a chunk (the Mamba and
                    RG-LRU layers' recurrence; ``repro::linear_scan``)
  staged_merge      the staged CSR build's merge: each sorted edge to its
                    slot (Alg. 2), beside its pair sort (CUB's radix sort)
"""
from ._lib import LAUNCHES, reset_launches
from .degree_histogram import degree_histogram, degree_histogram_ref
from .exclusive_scan import csr_offsets, exclusive_scan, exclusive_scan_ref
from .linear_scan import linear_scan, linear_scan_loop, linear_scan_ref
from .neighbor_gather import neighbor_gather, neighbor_gather_ref
from .parse_edges import (parse_accumulate, parse_accumulate_ref,
                          parse_bytes, parse_bytes_ref)
from .staged_merge import (sort_pairs, sort_pairs_ref, staged_merge,
                           staged_merge_ref)

__all__ = [
    "LAUNCHES", "reset_launches",
    "parse_bytes", "parse_bytes_ref", "parse_accumulate",
    "parse_accumulate_ref",
    "degree_histogram", "degree_histogram_ref",
    "exclusive_scan", "csr_offsets", "exclusive_scan_ref",
    "neighbor_gather", "neighbor_gather_ref",
    "linear_scan", "linear_scan_ref", "linear_scan_loop",
    "sort_pairs", "sort_pairs_ref", "staged_merge", "staged_merge_ref",
]
