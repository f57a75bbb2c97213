"""Public wrappers of the ``parse_bytes`` and ``parse_accumulate`` kernels.

A CPU tensor takes the plain PyTorch version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises.  Nothing falls back.
"""
from __future__ import annotations

import torch

from .. import _lib
from .kernel import parse_accumulate_kernel, parse_bytes_kernel
from .ref import parse_accumulate_ref, parse_bytes_ref


def _check_bufs(bufs: torch.Tensor) -> None:
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError(f"bufs must be a 2-D uint8 tensor, got "
                         f"{tuple(bufs.shape)} {bufs.dtype}")
    if bufs.device.type == "cpu":
        return
    _lib.require(bufs, torch.uint8, "bufs")
    _lib.check_device(bufs)
    if bufs.shape[1] > 1 and bufs.stride(1) != 1:
        raise ValueError("bufs needs unit column stride")
    if bufs.stride(0) < 0:
        raise ValueError("bufs needs a non-negative row stride")


def parse_bytes(bufs: torch.Tensor, owned_start: int, owned_end: int, *,
                weighted: bool, base: int):
    """Per-byte parse of ``(nb, buf_len)`` uint8 blocks: ``(valid, src,
    dst, w)``, the contract of the reference's ``parse_bytes_kernel``.

    ``bufs`` may be a strided view over a flat span (rows ``beta`` bytes
    apart, overlapping by ``buf_len - beta``); its columns must be
    contiguous.  ``w`` is None when unweighted.
    """
    _check_bufs(bufs)
    if bufs.device.type == "cpu":
        return parse_bytes_ref(bufs, owned_start, owned_end,
                               weighted=weighted, base=base)
    if bufs.numel() == 0:
        empty = torch.empty(bufs.shape, dtype=torch.int32, device=bufs.device)
        return (empty.bool(), empty, empty.clone(),
                empty.float() if weighted else None)
    out = parse_bytes_kernel(bufs, owned_start, owned_end, weighted=weighted,
                             base=base)
    _lib.LAUNCHES["parse_bytes"] += 1
    return out


def parse_accumulate(acc_src, acc_dst, acc_w, total, bufs, owned_start: int,
                     owned_end: int, *, weighted: bool, base: int,
                     edge_bound: int):
    """Parse ``bufs`` ``(nb, buf_len)`` and pack the batch's edges into the
    accumulators at ``total``, in place: the loader's step, the reference's
    ``repro/core/parse.py::parse_accumulate``.  Returns ``(acc_src,
    acc_dst, acc_w, new_total)``; on CUDA ``new_total`` is a fresh 0-d
    tensor and ``total`` is left as it was.

    Edge k of the batch (blocks in order, lines in order) goes to slot
    ``total + k``; edges with ``k >= edge_bound`` are dropped and the
    window's other slots ``[total + count, total + edge_bound)`` get the
    padding values -1 / -1 / 0.0.  The caller guarantees ``total +
    edge_bound <= len(acc_src)``.  ``acc_w`` is written when ``weighted``.
    """
    _check_bufs(bufs)
    if bufs.device.type == "cpu":
        return parse_accumulate_ref(acc_src, acc_dst, acc_w, total, bufs,
                                    owned_start, owned_end,
                                    weighted=weighted, base=base,
                                    edge_bound=edge_bound)
    accs = [("acc_src", acc_src, torch.int32), ("acc_dst", acc_dst,
                                                torch.int32)]
    if acc_w is not None:
        accs.append(("acc_w", acc_w, torch.float32))
    for name, t, dtype in accs:
        _lib.require(t, dtype, name)
        if t.dim() != 1 or not t.is_contiguous() or \
                t.shape != acc_src.shape or t.device != bufs.device:
            raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                             f"{tuple(acc_src.shape)} on {bufs.device}")
    _lib.require(total, torch.int32, "total")
    if total.dim() != 0 or total.device != bufs.device:
        raise ValueError(f"total must be a 0-d tensor on {bufs.device}")
    new_total = parse_accumulate_kernel(
        acc_src, acc_dst, acc_w if weighted else None, total, bufs,
        owned_start, owned_end, weighted=weighted, base=base,
        edge_bound=edge_bound)
    _lib.LAUNCHES["parse_accumulate"] += 1
    return acc_src, acc_dst, acc_w, new_total
