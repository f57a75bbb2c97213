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
