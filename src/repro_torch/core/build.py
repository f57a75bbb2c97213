"""Edgelist -> CSR construction strategies (GVEL §4.2.3-4.2.4), on the card.

The port of ``repro/core/build.py``.  Each builder places edge ``e`` with
source ``u`` at ``offsets[u] + rank(e among u's edges)``, the rank coming
from a stable sort, so the scatters have disjoint destinations:

* ``csr_global`` -- one global stable sort;
* ``csr_staged`` -- GVEL's multi-stage build over rho contiguous edge
  partitions, merged through per-partition bases: int32 (partition, source)
  keys and their values in one pair sort, then the ``staged_merge`` kernel;
* ``csr_binned`` -- sort-free levels over ``bin_bits``-wide digits of the
  vertex id, each a value sort of unique packed int32 keys.

In every builder the degree count goes through the ``degree_histogram``
kernel and the offsets through the ``exclusive_scan`` kernel and its
total; sorts, searchsorted and gathers are PyTorch ops, as the reference
leaves them to XLA (the staged build's pair sort is CUB's, on the card).
Padding is ``src == -1``.  Offsets are int32 (the device width);
``_check_offsets_width`` refuses edge counts that could wrap.

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
from ..kernels.staged_merge import sort_pairs, staged_merge
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


def _staged_scratch(buf: Optional[torch.Tensor], e: int, donate: bool,
                    dev) -> torch.Tensor:
    """``e`` int32 slots of scratch: past the edges of a donated buffer that
    holds ``2e`` slots or more, else fresh."""
    if donate and buf is not None and buf.shape[0] >= 2 * e:
        return buf[e:2 * e].view(I32)
    return torch.empty(e, dtype=I32, device=dev)


def _merge_table(pdeg: torch.Tensor, offsets: torch.Tensor, rho: int,
                 v: int) -> torch.Tensor:
    """``delta[p*V + u] = offsets[u] + before[p][u] - run start of (p, u)``
    (int32, flat) from the ``(rho*V,)`` partition degrees, which it
    overwrites.  With the inclusive scans down the partitions (C0) and over
    the flat keys (CF), ``before - start = (C0 - pdeg) - (CF - pdeg)``."""
    table = torch.cumsum(pdeg.view(rho, v), 0, dtype=I32)
    table -= pdeg.cumsum_(0).view(rho, v)
    table += offsets[:-1]
    return table.view(-1)


def staged_pairs(src: torch.Tensor, dst: torch.Tensor,
                 weights: Optional[torch.Tensor], num_vertices: int, *,
                 rho: int = 4, weighted: bool = False,
                 num_edges: Optional[int] = None, donate: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """``(offsets, sorted keys, sorted values, delta)``: all of
    :func:`csr_staged` but its merge, over int32 ``src`` and ``dst``."""
    e = src.shape[0] if num_edges is None else int(num_edges)
    _check_offsets_width(e)
    v = int(num_vertices)
    dev = src.device
    # the keys and their padding key rho*V fit int32 (and the sort 31 bits)
    rho = max(1, min(int(rho), INT32_OFFSETS_LIMIT // max(v, 1)))
    num_keys = rho * v
    # one sync: with every id in [0, V) the keys need no select and no
    # padding key, so the sort may take one bit fewer
    clean = True
    if e:
        lo, hi = torch.stack(torch.aminmax(src[:e])).tolist()
        clean = lo >= 0 and hi < v

    # ---- stage 1: keys, one pair sort, the partitions' degrees ------------
    keys = src[:e] if donate else torch.empty(e, dtype=I32, device=dev)
    cuts = np.linspace(0, e, rho + 1).astype(np.int64).tolist()
    pad = torch.full((), num_keys, dtype=I32, device=dev)
    for p in range(rho):
        s, k = src[cuts[p]:cuts[p + 1]], keys[cuts[p]:cuts[p + 1]]
        if not clean:
            torch.where((s >= 0) & (s < v), s + p * v, pad, out=k)
        elif p or not donate:
            torch.add(s, p * v, out=k)
    keys_alt = _staged_scratch(src, e, donate, dev)
    if weighted:
        vals = _staged_scratch(dst, e, donate, dev)
        torch.arange(e, dtype=I32, device=dev, out=vals)
        vals_alt = _staged_scratch(weights, e, donate, dev)
    else:
        vals = dst[:e] if donate else dst[:e].to(I32, copy=True)
        vals_alt = _staged_scratch(dst, e, donate, dev)
    bits = max((num_keys - 1 if clean else num_keys).bit_length(), 1)
    skeys, svals = sort_pairs(keys, vals, keys_alt, vals_alt, bits=bits)
    del keys, vals, keys_alt, vals_alt
    pdeg = degree_histogram(skeys, num_vertices=num_keys)       # (rho*V,)

    # ---- stage 2: global offsets, the merge's table -----------------------
    offsets = csr_offsets(torch.sum(pdeg.view(rho, v), dim=0, dtype=I32))
    delta = _merge_table(pdeg, offsets, rho, v)
    del pdeg
    return offsets, skeys, svals, delta


def csr_staged(src: torch.Tensor, dst: torch.Tensor,
               weights: Optional[torch.Tensor], num_vertices: int, *,
               rho: int = 4, weighted: bool = False,
               num_edges: Optional[int] = None, donate: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """GVEL multi-stage build (Algorithm 2, rank-based), carried in int32.

    Stage 1: rho contiguous partitions, cut as ``csr_staged_np`` cuts them;
             edge ``(u, v)`` of partition p gets the key ``p*V + u`` (``rho*V``
             for padding and ids outside ``[0, V)``), and one stable radix
             sort of (key, value) pairs over the keys' bits sorts every
             partition by source at once; the value is the destination id,
             or the edge's position when weights ride along.  The rho degree
             histograms are one histogram of the sorted keys.
    Stage 2: the summed degrees -> global offsets (scan); the table
             ``delta = offsets[u] + before[p][u] - (start of (p, u)'s sorted
             run)`` places the sorted element i at ``i + delta[key]``, so
             the destinations are disjoint, and one merge writes them.

    The product is ``num_edges`` targets (padding's slots -1, weight 0).
    ``num_edges`` (default: all of ``src``) counts the edges at the front of
    the buffers.  ``donate``: the caller hands the int32 buffers over, and
    the sort runs in their storage (and in their tails past the edges, where
    they hold twice the edges); otherwise the inputs stay untouched.
    """
    src, dst = src.to(I32), dst.to(I32)
    offsets, skeys, svals, delta = staged_pairs(
        src, dst, weights, num_vertices, rho=rho, weighted=weighted,
        num_edges=num_edges, donate=donate)
    e = skeys.shape[0]
    if weighted:
        targets, w = staged_merge(skeys, svals, delta, dst=dst[:e],
                                  weights=weights[:e])
    else:
        targets, w = staged_merge(skeys, svals, delta)
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
              bin_bits: Optional[int] = None, weighted: bool = False,
              num_edges: Optional[int] = None, donate: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The build named by ``method`` (``global``/``staged``/``binned``) of
    the first ``num_edges`` edges (default all); ``donate`` hands the
    buffers to the staged build (:func:`csr_staged`)."""
    if method == "staged":
        return csr_staged(src, dst, weights, num_vertices, rho=rho,
                          weighted=weighted, num_edges=num_edges,
                          donate=donate)
    if num_edges is not None:
        src, dst = src[:num_edges], dst[:num_edges]
        weights = weights[:num_edges] if weighted else None
    if method == "global":
        return csr_global(src, dst, weights, num_vertices, weighted=weighted)
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
