"""Launches of the staged build's pair sort (``csrc/pair_sort.cu``, CUB's
radix sort) and merge kernel (``csrc/staged_merge.cu``).

The merge replaces no TPU kernel: the reference's staged build merges with
XLA ops (``repro/core/build.py::csr_staged``).  One kernel per merge.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _lib


def sort_pairs_kernel(keys: torch.Tensor, vals: torch.Tensor,
                      keys_alt: torch.Tensor, vals_alt: torch.Tensor,
                      bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sorted pairs: ``(keys, vals)`` or ``(keys_alt, vals_alt)``,
    whichever the sort left them in (contiguous CUDA int32, n > 0)."""
    n = keys.shape[0]
    lib = _lib.lib()
    nbytes = lib.repro_sort_pairs_scratch_bytes(n, bits)
    if nbytes < 0:
        raise RuntimeError(f"sort_pairs: CUB refused {n} pairs of {bits} "
                           f"bits")
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                          device=keys.device)
    selector = ctypes.c_int32(0)
    status = lib.repro_sort_pairs(
        keys.data_ptr(), keys_alt.data_ptr(), vals.data_ptr(),
        vals_alt.data_ptr(), n, bits, scratch.data_ptr(), nbytes,
        ctypes.byref(selector), _lib.stream_of(keys))
    _lib.check(status, "sort_pairs launch")
    return (keys_alt, vals_alt) if selector.value else (keys, vals)


def staged_merge_kernel(keys: torch.Tensor, vals: torch.Tensor,
                        delta: torch.Tensor, dst: Optional[torch.Tensor],
                        weights: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fresh ``(targets, weights)`` for contiguous CUDA inputs, n > 0."""
    n = keys.shape[0]
    targets = torch.empty(n, dtype=torch.int32, device=keys.device)
    w_out = None if weights is None else torch.empty(
        n, dtype=torch.float32, device=keys.device)
    status = _lib.lib().repro_staged_merge(
        keys.data_ptr(), vals.data_ptr(), n, delta.data_ptr(),
        delta.shape[0], None if dst is None else dst.data_ptr(),
        None if weights is None else weights.data_ptr(), targets.data_ptr(),
        None if w_out is None else w_out.data_ptr(), _lib.stream_of(keys))
    _lib.check(status, "staged_merge launch")
    return targets, w_out
