"""Edgelist -> CSR construction strategies (GVEL §4.2.3-4.2.4), on the card.

The port of ``repro/core/build.py``.  Each builder places edge ``e`` with
source ``u`` at ``offsets[u] + rank(e among u's edges)``, the rank coming
from a stable sort, so the scatters have disjoint destinations:

* ``csr_global`` -- one global stable sort;
* ``csr_staged`` -- GVEL's multi-stage build over rho contiguous edge
  partitions, merged through per-partition bases;
* ``csr_binned`` -- sort-free levels over ``bin_bits``-wide digits of the
  vertex id, each a value sort of unique packed int32 keys.

In every builder the degree count goes through the ``degree_histogram``
kernel and the offsets through the ``exclusive_scan`` kernel and its
total; sorts, searchsorted and gathers are PyTorch ops, as the reference
leaves them to XLA.  Padding is ``src == -1``.  Offsets are int32 (the
device width); ``_check_offsets_width`` refuses edge counts that could
wrap.

The host builds are the reference's numpy code, copied as it is:
``csr_staged_np`` (rho partitions on a thread pool of ``num_workers``),
``csr_binned_np`` (vertex-range bins filled on a thread pool) and the
oracle ``csr_np``; their offsets are int64.  The first two return CPU
tensors over their numpy results (the host engines' CSR, moved to its
device by the caller); ``csr_np`` returns numpy arrays, as the tests'
oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.degree_histogram import degree_histogram
from ..kernels.exclusive_scan import csr_offsets
from .types import CSR

I32 = torch.int32

INT32_OFFSETS_LIMIT = 2**31 - 1


def _check_offsets_width(num_edges: int) -> None:
    if num_edges > INT32_OFFSETS_LIMIT:
        raise ValueError(
            f"edge count {num_edges} exceeds int32 offsets "
            f"(limit {INT32_OFFSETS_LIMIT}); the device builds accumulate "
            "offsets in int32 -- build on the host for graphs this large: "
            "engine='numpy' or 'threads', or convert_to_csr(el, "
            "engine='numpy') (int64 offsets)")


def _ceil_log2(n: int) -> int:
    return max(int(n - 1).bit_length(), 0)


def _rank_in_group(sorted_key: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Rank of each sorted element within its equal-key run; works on the
    last dimension of ``(..., E)`` keys."""
    dev = sorted_key.device
    if sorted_key.shape[-1] == 0:
        return torch.zeros(sorted_key.shape, dtype=I32, device=dev)
    ids = torch.arange(num_vertices + 1, dtype=I32, device=dev)
    ids = ids.expand(*sorted_key.shape[:-1], num_vertices + 1).contiguous()
    first = torch.searchsorted(sorted_key.contiguous(), ids, side="left",
                               out_int32=True)
    iota = torch.arange(sorted_key.shape[-1], dtype=I32, device=dev)
    return iota - torch.gather(first, -1,
                               sorted_key.clamp(0, num_vertices).long())


def _scatter_drop(size: int, dest: torch.Tensor, values: torch.Tensor,
                  fill) -> torch.Tensor:
    """``full(size, fill).at[dest].set(values, mode="drop")`` for
    ``dest`` in ``[0, size]`` (``size`` is the drop slot)."""
    out = torch.full((size + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[dest.long()] = values
    return out[:size]


def csr_global(src: torch.Tensor, dst: torch.Tensor,
               weights: Optional[torch.Tensor], num_vertices: int, *,
               weighted: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Single-stage build: one global stable sort."""
    _check_offsets_width(src.shape[0])
    v = num_vertices
    key = torch.where(src >= 0, src, v).to(I32)
    order = torch.argsort(key, stable=True)
    targets = dst[order]
    w = weights[order] if weighted else None
    offsets = csr_offsets(degree_histogram(key, num_vertices=v))
    return offsets, targets, w


def csr_staged(src: torch.Tensor, dst: torch.Tensor,
               weights: Optional[torch.Tensor], num_vertices: int, *,
               rho: int = 4, weighted: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """GVEL multi-stage build (Algorithm 2, rank-based).

    Stage 1: rho contiguous partitions, each stably sorted by source; their
             rho degree histograms in one launch (the reference's vmap).
    Stage 2: partition degrees -> global offsets (scan) + per-partition
             bases; edge destination = offsets[u] + (edges of u in earlier
             partitions) + local rank.  Destinations are disjoint.
    """
    _check_offsets_width(src.shape[0])
    v = num_vertices
    e = src.shape[0]
    dev = src.device
    pcap = -(-e // rho)
    pad = rho * pcap - e
    key = torch.where(src >= 0, src, v).to(I32)
    if pad:
        key = torch.cat([key, torch.full((pad,), v, dtype=I32, device=dev)])
        dst = torch.cat([dst, torch.full((pad,), -1, dtype=I32, device=dev)])
        if weighted:
            weights = torch.cat([weights, weights.new_zeros(pad)])
    key = key.reshape(rho, pcap)
    dstp = dst.reshape(rho, pcap)

    # ---- stage 1: partition-local sorts and degrees ----------------------
    order = torch.argsort(key, dim=1, stable=True)
    skey = torch.gather(key, 1, order)
    sdst = torch.gather(dstp, 1, order)
    pdeg = degree_histogram(skey, num_vertices=v)               # (rho, V)
    rank = _rank_in_group(skey, v)

    # ---- stage 2: global offsets + disjoint merge -------------------------
    deg = torch.sum(pdeg, dim=0, dtype=I32)
    offsets = csr_offsets(deg)
    before = torch.cumsum(pdeg, dim=0, dtype=I32) - pdeg        # (rho, V)
    base = offsets[:-1][None, :] + before
    # one extra column keeps the gather in range for keys >= V, whose
    # destinations are dropped below
    base = torch.cat([base, base.new_zeros(rho, 1)], dim=1)
    dest = torch.gather(base, 1, skey.clamp(0, v).long()) + rank
    dest = torch.where(skey < v, dest, e).reshape(-1)
    targets = _scatter_drop(e, dest, sdst.reshape(-1), -1)
    w = None
    if weighted:
        sw = torch.gather(weights.reshape(rho, pcap), 1, order)
        w = _scatter_drop(e, dest, sw.reshape(-1), 0.0)
    return offsets, targets, w


def _bin_level_widths(v_bits: int, bin_bits: int, avail: int) -> Tuple[int, ...]:
    """Digit widths per level, low bits first (see the reference)."""
    width = max(1, min(bin_bits, avail))
    widths = []
    rem = max(v_bits, 1)
    while rem > 0:
        widths.append(min(width, rem))
        rem -= widths[-1]
    return tuple(widths)


def csr_binned(src: torch.Tensor, dst: torch.Tensor,
               weights: Optional[torch.Tensor], num_vertices: int, *,
               bin_bits: Optional[int] = None, weighted: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Binned build: per level, ``(digit << pos_bits) | position`` packed
    into one int32 and value-sorted (keys are unique, so the sort is the
    stable rank and its low bits are the level's permutation); padding
    takes a sentinel digit in the top level.  Offsets from one histogram
    of ``clip(src, 0, V-1)`` over the valid edges, then the scan."""
    _check_offsets_width(src.shape[0])
    v = num_vertices
    e = src.shape[0]
    dev = src.device
    v_bits = _ceil_log2(v)
    pos_bits = max(_ceil_log2(e), 1)
    avail = 31 - pos_bits - 1          # -1: top-level padding sentinel bit
    if avail < 1:
        raise ValueError(
            f"csr_binned needs ceil(log2(E)) <= 29 to pack int32 level keys "
            f"(E={e}); use csr_staged")
    widths = _bin_level_widths(v_bits, avail if bin_bits is None else bin_bits,
                               avail)
    valid = src >= 0
    iota = torch.arange(e, dtype=I32, device=dev)
    pos_mask = (1 << pos_bits) - 1
    perm = iota.long()
    shift = 0
    for li, width in enumerate(widths):
        cur = src if li == 0 else src[perm]
        dig = (cur >> shift) & ((1 << width) - 1)
        if li == len(widths) - 1:
            pad = valid if li == 0 else valid[perm]
            dig = torch.where(pad, dig, 1 << width)
        key = (dig.to(I32) << pos_bits) | iota
        level = (torch.sort(key).values & pos_mask).long()
        perm = level if li == 0 else perm[level]
        shift += width
    targets = dst[perm]
    w = weights[perm] if weighted else None
    hist_in = torch.where(valid, src.clamp(0, max(v - 1, 0)), -1)
    offsets = csr_offsets(degree_histogram(hist_in, num_vertices=v))
    return offsets, targets, w


def build_csr(src: torch.Tensor, dst: torch.Tensor,
              weights: Optional[torch.Tensor], num_vertices: int, *,
              method: str = "staged", rho: int = 4,
              bin_bits: Optional[int] = None, weighted: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The build named by ``method`` (``global``/``staged``/``binned``)."""
    if method == "global":
        return csr_global(src, dst, weights, num_vertices, weighted=weighted)
    if method == "staged":
        return csr_staged(src, dst, weights, num_vertices, rho=rho,
                          weighted=weighted)
    if method == "binned":
        return csr_binned(src, dst, weights, num_vertices, bin_bits=bin_bits,
                          weighted=weighted)
    raise ValueError(f"unknown method {method!r}")


def host_csr(offsets: np.ndarray, targets: np.ndarray,
              weights: Optional[np.ndarray], num_vertices: int) -> CSR:
    """A host build's arrays as a CSR of CPU tensors (no copy)."""
    return CSR(torch.from_numpy(offsets), torch.from_numpy(targets),
               None if weights is None else torch.from_numpy(weights),
               num_vertices)


def csr_binned_np(src: np.ndarray, dst: np.ndarray,
                  weights: Optional[np.ndarray], num_vertices: int, *,
                  bin_bits: Optional[int] = None,
                  num_workers: int = 1) -> CSR:
    """Host binned build: bucket edges by contiguous vertex range, then
    fill each bin independently (cache-sized subproblems; threads across
    bins -- numpy's sort releases the GIL).

    Bucketing is the cumulative-count rank, one pass per bin (B small):
    dest = bin_start[bin] + arrival rank within bin.  The per-bin fill
    value-sorts (local_id << 32) | within_bin_position packed into int64 --
    unique keys, so the plain value sort is the stable rank, and targets /
    weights land by gather through disjoint per-bin destinations."""
    from concurrent.futures import ThreadPoolExecutor

    v = num_vertices
    m = src >= 0
    src = np.ascontiguousarray(src[m], np.int64)
    dst = dst[m]
    weights = weights[m] if weights is not None else None
    e = len(src)
    v_bits = _ceil_log2(v)
    if bin_bits is None:
        bin_bits = max(v_bits - 4, 1)        # ~16 bins by default
    bin_bits = max(bin_bits, 1)
    nbins = max((v + (1 << bin_bits) - 1) >> bin_bits, 1)

    deg = np.bincount(src, minlength=v)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    targets = np.empty(e, np.int32)
    wout = np.empty(e, weights.dtype) if weights is not None else None
    if e == 0:
        return host_csr(offsets, targets, wout, v)

    # ---- bucket: cumulative-count rank into bins (one cumsum per bin) ----
    bins = src >> bin_bits
    bcount = np.bincount(bins, minlength=nbins)
    bstart = np.zeros(nbins + 1, np.int64)
    np.cumsum(bcount, out=bstart[1:])
    dest1 = np.empty(e, np.int64)
    for b in range(nbins):
        hit = bins == b
        dest1[hit] = bstart[b] + np.arange(int(bcount[b]))
    perm1 = np.empty(e, np.int64)
    perm1[dest1] = np.arange(e)

    # ---- per-bin contention-free fills (threadable, cache-sized) --------
    def fill(b):
        lo, hi = int(bstart[b]), int(bstart[b + 1])
        if lo == hi:
            return
        edges = perm1[lo:hi]
        local = src[edges] & ((1 << bin_bits) - 1)
        packed = (local << 32) | np.arange(hi - lo)
        order = np.sort(packed) & 0xFFFFFFFF
        csr_order = edges[order]
        targets[lo:hi] = dst[csr_order]
        if wout is not None:
            wout[lo:hi] = weights[csr_order]

    if num_workers == 1 or nbins == 1:
        for b in range(nbins):
            fill(b)
    else:
        with ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(fill, range(nbins)))
    return host_csr(offsets, targets, wout, v)


def csr_staged_np(src: np.ndarray, dst: np.ndarray,
                  weights: Optional[np.ndarray], num_vertices: int, *,
                  rho: int = 4, num_workers: int = 1) -> CSR:
    """Host (numpy) staged build with a thread pool over partitions --
    the multicore realization of Algorithm 2: partition-local sorts run
    on separate cores (numpy sort releases the GIL), then the disjoint
    merge scatters in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    v = num_vertices
    e = len(src)
    cuts = np.linspace(0, e, rho + 1).astype(np.int64)

    def local(p):
        s = src[cuts[p]:cuts[p + 1]]
        d = dst[cuts[p]:cuts[p + 1]]
        order = np.argsort(s, kind="stable")
        skey = s[order]
        deg = np.bincount(skey, minlength=v)
        w = weights[cuts[p]:cuts[p + 1]][order] if weights is not None else None
        return skey, d[order], deg, w

    if num_workers == 1:
        parts = [local(p) for p in range(rho)]
    else:
        with ThreadPoolExecutor(num_workers) as pool:
            parts = list(pool.map(local, range(rho)))

    pdeg = np.stack([p[2] for p in parts])                 # (rho, V)
    deg = pdeg.sum(axis=0)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    before = np.cumsum(pdeg, axis=0) - pdeg                # (rho, V) excl
    targets = np.empty(e, np.int32)
    wout = np.empty(e, np.float32) if weights is not None else None

    def merge(p):
        skey, sdst, pdg, w = parts[p]
        local_off = np.zeros(v + 1, np.int64)
        np.cumsum(pdg, out=local_off[1:])
        rank = np.arange(len(skey)) - local_off[skey]
        dest = offsets[skey] + before[p][skey] + rank
        targets[dest] = sdst
        if wout is not None:
            wout[dest] = w

    if num_workers == 1:
        for p in range(rho):
            merge(p)
    else:
        with ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(merge, range(rho)))
    return host_csr(offsets, targets, wout, v)


def csr_np(src: np.ndarray, dst: np.ndarray, weights: Optional[np.ndarray],
           num_vertices: int) -> CSR:
    """Host oracle: numpy stable sort."""
    m = src >= 0
    src, dst = src[m], dst[m]
    weights = weights[m] if weights is not None else None
    order = np.argsort(src, kind="stable")
    deg = np.bincount(src, minlength=num_vertices)
    offsets = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    return CSR(offsets, dst[order].astype(np.int32),
               None if weights is None else weights[order], num_vertices)
