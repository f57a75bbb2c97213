"""Launch of the ``parse_bytes`` CUDA kernel (``csrc/parse_edges.cu``).

Replaces ``repro/kernels/parse_edges/kernel.py:125`` ``parse_bytes_kernel``.
The kernel reads the staged bytes through a row stride, so ``bufs`` may be
a view whose rows alias (the loader's flat span with stride ``beta``).
"""
from __future__ import annotations

import torch

from .. import _lib


def parse_bytes_kernel(bufs: torch.Tensor, owned_start: int, owned_end: int,
                       *, weighted: bool, base: int):
    """``(valid, src, dst, w)`` for a CUDA ``(nb, buf_len)`` uint8 view
    with unit column stride.  ``src``/``dst``/``w`` are written only at
    valid bytes."""
    nb, buf_len = bufs.shape
    dev = bufs.device
    valid = torch.empty((nb, buf_len), dtype=torch.bool, device=dev)
    src = torch.empty((nb, buf_len), dtype=torch.int32, device=dev)
    dst = torch.empty((nb, buf_len), dtype=torch.int32, device=dev)
    w = (torch.empty((nb, buf_len), dtype=torch.float32, device=dev)
         if weighted else None)
    status = _lib.lib().repro_parse_bytes(
        bufs.data_ptr(), bufs.stride(0), nb, buf_len, int(owned_start),
        int(owned_end), int(base), int(bool(weighted)), valid.data_ptr(),
        src.data_ptr(), dst.data_ptr(), None if w is None else w.data_ptr(),
        _lib.stream_of(bufs))
    _lib.check(status, "parse_bytes launch")
    return valid, src, dst, w


def parse_accumulate_kernel(acc_src, acc_dst, acc_w, total, bufs,
                            owned_start: int, owned_end: int, *,
                            weighted: bool, base: int, edge_bound: int):
    """Parse a CUDA ``(nb, buf_len)`` uint8 view (unit column stride) and
    pack its edges into the accumulators at the device-resident ``total``
    (in place).  Returns the new total, a fresh 0-d int32 tensor: every CTA
    reads ``total``, so it is never overwritten."""
    nb, buf_len = bufs.shape
    lib = _lib.lib()
    scratch = torch.empty(
        lib.repro_parse_accumulate_scratch_bytes(nb, buf_len,
                                                 int(owned_start),
                                                 int(owned_end)),
        dtype=torch.uint8, device=bufs.device)
    total_out = torch.empty((), dtype=torch.int32, device=bufs.device)
    status = lib.repro_parse_accumulate(
        bufs.data_ptr(), bufs.stride(0), nb, buf_len, int(owned_start),
        int(owned_end), int(base), int(bool(weighted)), acc_src.data_ptr(),
        acc_dst.data_ptr(), None if acc_w is None else acc_w.data_ptr(),
        acc_src.shape[0], total.data_ptr(), total_out.data_ptr(),
        int(edge_bound), scratch.data_ptr(), _lib.stream_of(bufs))
    _lib.check(status, "parse_accumulate launch")
    return total_out
