"""Edgelist parsing on the card (GVEL Algorithm 1).

The port of ``repro/core/parse.py``, over the kernels of
``kernels.parse_edges``:

* :func:`parse_accumulate` -- the streaming loader's step: a batch of
  blocks in, its edges packed into the accumulators at the device-resident
  running ``total``, with no host sync: ``kernels.parse_accumulate``, on
  CUDA one fused kernel that parses and packs, on the CPU its plain
  version (the per-byte parse ``_parse_block_bytes``, then
  ``kernels.parse_edges.ref.compact_accumulate_ref``);
* :func:`parse_block` / :func:`parse_blocks` -- block in, fixed-capacity
  per-block ``(src, dst, w, count)`` out: the ``parse_bytes`` kernel, then
  the per-block compaction in torch ops.

The accumulators are updated **in place** (the reference donates them to
the same effect); callers keep using the tensors they passed.
"""
from __future__ import annotations

import torch

from ..kernels.parse_edges import parse_accumulate, parse_bytes
from ..kernels.parse_edges.ref import parse_bytes_ref as _parse_block_bytes

I32 = torch.int32

# calls of parse_blocks (parse_block included), zeroed by the caller; the
# loader runs parse_accumulate instead, and a load shows 0 here
CALLS = {"parse_blocks": 0}

__all__ = ["parse_accumulate", "parse_block", "parse_blocks",
           "make_accumulators", "_parse_block_bytes"]


def _compact_blocks(valid, src_b, dst_b, w_b, *, edge_cap: int):
    """Per-block compaction of ``(nb, n)`` byte-domain parses into
    fixed-capacity ``(src, dst, w, counts)``: the reference's
    ``_compact_block`` (XLA outside its Pallas kernel), as torch ops."""
    nb, n = valid.shape
    dev = valid.device
    pos = torch.cumsum(valid, 1, dtype=I32) - 1
    count = (pos[:, -1] + 1).clamp(min=0) if n else \
        torch.zeros(nb, dtype=I32, device=dev)
    slot = torch.where(valid & (pos < edge_cap), pos, edge_cap)
    packed = torch.full((nb, edge_cap + 1), n, dtype=I32, device=dev)
    packed.scatter_(1, slot.long(),
                    torch.arange(n, dtype=I32, device=dev).expand(nb, n))
    packed = packed[:, :edge_cap]
    pv = packed < n
    pc = packed.clamp(max=max(n - 1, 0)).long()
    src = torch.where(pv, torch.gather(src_b, 1, pc), -1)
    dst = torch.where(pv, torch.gather(dst_b, 1, pc), -1)
    w = None if w_b is None else \
        torch.where(pv, torch.gather(w_b, 1, pc), 0.0)
    return src, dst, w, count


def parse_blocks(bufs, owned_start: int, owned_end: int, *, weighted: bool,
                 base: int, edge_cap: int):
    """Parse ``(nb, n)`` blocks into fixed-capacity ``(src, dst, w,
    counts)``: ``(nb, edge_cap)`` rows padded with -1 / -1 / 0.0 and
    ``(nb,)`` int32 counts (``w`` is None when unweighted).  The contract
    of ``repro/kernels/parse_edges/kernel.py::parse_edges_kernel``: the
    ``parse_bytes`` kernel, then :func:`_compact_blocks`."""
    CALLS["parse_blocks"] += 1
    valid, src_b, dst_b, w_b = parse_bytes(bufs, owned_start, owned_end,
                                           weighted=weighted, base=base)
    return _compact_blocks(valid, src_b, dst_b, w_b if weighted else None,
                           edge_cap=edge_cap)


def parse_block(buf, owned_start: int, owned_end: int, *, weighted: bool,
                base: int, edge_cap: int):
    """One ``(n,)`` block -> ``(src, dst, w, count)``, as :func:`parse_blocks`."""
    src, dst, w, count = parse_blocks(buf[None], owned_start, owned_end,
                                      weighted=weighted, base=base,
                                      edge_cap=edge_cap)
    return src[0], dst[0], None if w is None else w[0], count[0]


def make_accumulators(cap: int, *, weighted: bool, device=None):
    """Fresh packed edge accumulators on ``device``: ``(src=-1, dst=-1,
    w=0, total=0)``; ``total`` is an int32 scalar that stays on the
    device."""
    cap = max(int(cap), 1)
    acc_src = torch.full((cap,), -1, dtype=I32, device=device)
    acc_dst = torch.full((cap,), -1, dtype=I32, device=device)
    acc_w = torch.zeros(cap, dtype=torch.float32, device=device) \
        if weighted else None
    total = torch.zeros((), dtype=I32, device=device)
    return acc_src, acc_dst, acc_w, total
