"""The sharded streaming load: GVEL's staging spread over a device mesh.

The port of ``repro/core/distributed.py``, written the way PyTorch runs
several devices: one process per rank (SPMD over ``torch.distributed``),
where the reference drives every shard from one controller.  The
reference's mesh and axis name become a
``torch.distributed.device_mesh.DeviceMesh`` and one of its
``mesh_dim_names``; every rank makes the same call and gets its own rows:

    mesh = init_device_mesh("cuda", (d,), mesh_dim_names=("data",))
    csr = open_graph(path).csr_sharded(mesh, axis="data")

  stage 0  each rank streams its own block-aligned byte span of the file
           (:func:`~.blocks.shard_plan`) through the fused parse into
           packed accumulators on its device (:func:`stream_shards`);
  stage 1  the ranks agree on the sizes: edge counts, the largest id and
           an ok flag in one ``all_gather``, the per-owner bucket counts in
           another (:func:`bucket_histogram`);
  stage 2  edges are bucketed by owner rank (a vertex-range partition)
           and exchanged in one ``all_to_all_single`` per buffer
           (:func:`exchange_by_owner`), the only bulk communication;
  stage 3  each rank builds the CSR rows of its own range locally
           (:func:`build_local_csr`, through the histogram and scan
           kernels).

Rank k's result is row k of the reference's ``(d, .)`` global arrays, as
the port's row-local :class:`~.types.CSR`: ``rows = ceil(V/d)`` rows
starting at ``row_start = k * rows``, int32 offsets, and the receive-sized
``targets``/``weights`` (-1 / 0.0 past the valid prefix).  Every size a
buffer is allocated with is agreed by a collective first, so no rank waits
in an exchange that another has left: a shard that fails, or a bucket that
overflows, raises on every rank.

The tensors live on the mesh's device: ``cuda:{torch.cuda.current_device()}``
on a ``"cuda"`` mesh (the caller sets it, usually from ``LOCAL_RANK``), the
CPU on a ``"cpu"`` mesh (gloo).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from contextlib import nullcontext
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import build, faults
from .types import CSR

I32 = torch.int32


def _cap_round(n: int) -> int:
    """Smallest value in ``{2**k, 3 * 2**(k-1)}`` that is >= max(n, 1): a
    half-step power-of-two ladder, so measured capacities (send buckets,
    valid-edge bounds) stay within 1.5x of the need."""
    n = max(int(n), 1)
    p = 1 << (n - 1).bit_length()
    h = (3 * p) // 4
    return h if h >= n else p


def _owner(vid: torch.Tensor, rows_per_shard: int) -> torch.Tensor:
    return torch.clamp(vid // rows_per_shard, min=0)


def _axis(mesh, axis: str):
    """``(group, d, k)``: the process group along ``axis``, its size and
    this rank's index in it."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    group = mesh.get_group(axis)
    return group, group.size(), mesh.get_local_rank(axis)


def _mesh_device(mesh) -> torch.device:
    """Where this rank's tensors live: the current CUDA device on a
    ``"cuda"`` mesh (raising without one), the CPU on a ``"cpu"`` mesh."""
    from .env import resolve_device
    if mesh.device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device type "
                         f"{mesh.device_type!r}; use 'cuda' or 'cpu'")
    return resolve_device(mesh.device_type)


def _all_gather(x: torch.Tensor, group, d: int) -> torch.Tensor:
    """``(d, *x.shape)``: every rank's ``x``, in rank order."""
    out = [torch.empty_like(x) for _ in range(d)]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out)


def bucket_by_owner(src: torch.Tensor, dst: torch.Tensor,
                    w: Optional[torch.Tensor], *, num_shards: int,
                    rows_per_shard: int, send_cap: int):
    """The local half of :func:`exchange_by_owner`: this rank's edges
    (``src == -1`` pads) in ``(num_shards * send_cap,)`` send buffers, owner
    j's bucket at ``[j * send_cap, (j + 1) * send_cap)`` (pads -1 / -1 /
    0.0), and the count of edges that did not fit their bucket.

    The bucketing is stable: an edge's slot in its bucket is the number of
    earlier edges with the same owner (a cumulative count over the one-hot
    owner, no sort), so a bucket keeps the order of ``src``.  With the
    sender-major layout of ``all_to_all_single`` and spans in file order,
    a rank receives its edges in global file order, which is what makes
    the sharded CSR bitwise equal to the oracle's."""
    d = num_shards
    dev = src.device
    owner = torch.where(src >= 0, _owner(src, rows_per_shard), d)
    # one-hot rows (d, e), so each owner's count runs along the contiguous
    # dimension (a scan down a tall (e, d) column is serial per column)
    oh = (owner[None, :] == torch.arange(d, dtype=owner.dtype,
                                         device=dev)[:, None]).to(I32)
    rank = torch.gather(torch.cumsum(oh, 1, dtype=I32), 0,
                        owner.clamp(0, d - 1)[None, :].long())[0] - 1
    del oh
    routed = owner < d
    keep = routed & (rank < send_cap)
    overflow = torch.sum(routed & (rank >= send_cap), dtype=I32)
    buf = d * send_cap
    slot = torch.where(keep, owner.long() * send_cap + rank, buf)
    snd_src = build._scatter_drop(buf, slot, src.to(I32), -1)
    snd_dst = build._scatter_drop(buf, slot, dst.to(I32), -1)
    snd_w = None if w is None else \
        build._scatter_drop(buf, slot, w.to(torch.float32), 0.0)
    return snd_src, snd_dst, snd_w, overflow


def exchange_by_owner(src: torch.Tensor, dst: torch.Tensor,
                      w: Optional[torch.Tensor], *, num_shards: int,
                      rows_per_shard: int, send_cap: int, group
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor], torch.Tensor]:
    """Bucket this rank's edges by owner (:func:`bucket_by_owner`) and
    exchange them: ``(rcv_src, rcv_dst, rcv_w, count)``, receive buffers of
    ``num_shards * send_cap`` slots (sender j's bucket for this rank at
    ``[j * send_cap, (j + 1) * send_cap)``) and the count of valid edges
    received.

    ``send_cap`` is the per-(sender, owner) bucket capacity: GVEL-style
    over-allocation, so the exchange is one dense collective.  Before it,
    the ranks gather their overflow counts, send caps and row ranges: when
    any bucket overflowed (the exchange would drop edges) or the ranks
    disagree on a size, every rank raises ``ValueError`` together, and
    none is left waiting in the exchange."""
    d = num_shards
    snd_src, snd_dst, snd_w, overflow = bucket_by_owner(
        src, dst, w, num_shards=d, rows_per_shard=rows_per_shard,
        send_cap=send_cap)
    sizes = torch.tensor([send_cap, rows_per_shard], dtype=torch.int64,
                         device=src.device)
    agreed = _all_gather(torch.cat([overflow.to(torch.int64)[None], sizes]),
                         group, d).tolist()
    ovf = [row[0] for row in agreed]
    if len({tuple(row[1:]) for row in agreed}) > 1:
        raise ValueError(f"exchange_by_owner: the ranks disagree on "
                         f"(send_cap, rows_per_shard): "
                         f"{[tuple(row[1:]) for row in agreed]}")
    if sum(ovf):
        raise ValueError(
            f"exchange_by_owner overflow: {sum(ovf)} edge(s) (worst shard: "
            f"{max(ovf)}) did not fit their per-owner bucket at "
            f"send_cap={send_cap}; the exchange would drop them.  Raise "
            f"send_cap (worst case: the per-shard buffer capacity "
            f"{src.shape[0]}) or let load_csr_sharded_stream measure it "
            f"from the real bucket counts.")

    def a2a(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    rcv_src, rcv_dst = a2a(snd_src), a2a(snd_dst)
    rcv_w = None if snd_w is None else a2a(snd_w)
    return rcv_src, rcv_dst, rcv_w, torch.sum(rcv_src >= 0, dtype=I32)


def build_local_csr(src: torch.Tensor, dst: torch.Tensor,
                    w: Optional[torch.Tensor], *, rows_per_shard: int,
                    shard: int, rho: int = 4, method: str = "staged",
                    bin_bits: Optional[int] = None):
    """``(offsets, targets, weights)`` of the rows shard ``shard`` owns,
    from the edges it received: the ``staged`` or ``binned`` build over
    local row ids (so the histogram and scan kernels launch).  The received
    buffers are the exchange's own: the staged build sorts in ``dst`` and
    ``w`` (and in the local ids' buffer), so it overwrites them."""
    local = torch.where(src >= 0, src - shard * rows_per_shard, -1)
    if method == "binned":
        return build.csr_binned(local, dst, w, rows_per_shard,
                                bin_bits=bin_bits, weighted=w is not None)
    if method != "staged":
        raise ValueError(f"sharded build method must be 'staged' or "
                         f"'binned', got {method!r}")
    return build.csr_staged(local, dst, w, rows_per_shard, rho=rho,
                            weighted=w is not None, donate=True)


def load_csr_sharded(mesh, axis: str, src: torch.Tensor, dst: torch.Tensor,
                     w: Optional[torch.Tensor], *, num_vertices: int,
                     rho: int = 4, method: str = "staged",
                     bin_bits: Optional[int] = None,
                     send_cap: Optional[int] = None,
                     edge_limit: Optional[int] = None) -> CSR:
    """This rank's edge buffers -> its rows of the CSR sharded on ``axis``
    (every rank calls it, each with buffers of one length).

    ``send_cap`` defaults to the worst case (every local edge owned by one
    rank); :func:`load_csr_sharded_stream` measures it.  A bucket that
    overflows ``send_cap`` raises ``ValueError`` on every rank, never a
    CSR with dropped edges.  ``edge_limit`` bounds the valid edges of every
    rank's buffers (the accumulators pack them at the front), so the
    bucketing never reads the padding; the caller answers for the bound."""
    group, d, k = _axis(mesh, axis)
    rows = max(-(-num_vertices // d), 1)
    e_per = src.shape[0]
    if send_cap is None:
        send_cap = e_per      # worst case: every local edge to one owner
    lim = e_per if edge_limit is None else max(min(int(edge_limit), e_per), 1)
    rs, rd, rw, _ = exchange_by_owner(
        src[:lim], dst[:lim], None if w is None else w[:lim], num_shards=d,
        rows_per_shard=rows, send_cap=int(send_cap), group=group)
    off, tgt, tw = build_local_csr(rs, rd, rw, rows_per_shard=rows, shard=k,
                                   rho=rho, method=method, bin_bits=bin_bits)
    return CSR(off, tgt, tw if w is not None else None, num_vertices,
               row_start=k * rows)


def stream_shards(mesh, axis: str, path: str, *, weighted: bool = False,
                  base: int = 1, offset: int = 0, beta: Optional[int] = None,
                  overlap: Optional[int] = None,
                  batch_blocks: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor], List[int], int]:
    """Stage 0: this rank streams its own byte span of the file.

    The file's ``BlockPlan`` is split into ``d`` block-aligned spans.  The
    split must be the same on every rank, so the ranks gather their file
    lengths and geometries first and all plan with rank 0's ``beta`` and
    ``overlap`` (ranks that tuned on their own may have measured other
    winners); a file of another length on some rank raises on every rank.
    This rank then opens a source over its span (raw: a shared mmap; framed: a
    frame-index seek; gzip: the prefix inflated and dropped) and runs the
    fused streaming parse into accumulators of ``e_per`` slots on its
    device, staging inline (the rank is its own pipeline).

    A shard re-executes its whole span after transient faults its in-span
    retries could not absorb (up to ``faults.SHARD_RETRIES`` times,
    counted as ``shard_retries``; a re-executed span is bitwise the first
    try's), and a load that outlasts ``faults.WATCHDOG_S`` is abandoned as
    a ``StageTimeout``.  The ranks then gather an ok flag, their edge
    counts and their largest ids; if any shard failed, every rank raises
    (the failed one its own error, the others a ``ShardLoadError`` naming
    it).

    Returns ``(src, dst, w, counts, max_vertex_id)``: this rank's packed
    buffers, every rank's edge count and the largest id on any rank (-1
    when the file has no edge).
    """
    from . import codecs, loader
    from .blocks import plan_blocks, shard_plan
    from .parse import make_accumulators

    group, d, k = _axis(mesh, axis)
    dev = _mesh_device(mesh)
    beta = loader.DEFAULT_BETA if beta is None else beta
    overlap = loader.DEFAULT_OVERLAP if overlap is None else overlap
    batch_blocks = (loader.DEFAULT_BATCH_BLOCKS if batch_blocks is None
                    else batch_blocks)
    length, forced_beta = codecs.stream_geometry(path, offset)
    if forced_beta is not None and forced_beta > overlap:
        beta = forced_beta
    geometry = _all_gather(torch.tensor([length, beta, overlap],
                                        dtype=torch.int64, device=dev),
                           group, d).tolist()
    if len({row[0] for row in geometry}) > 1:
        raise ValueError(f"{path}: the ranks see different lengths "
                         f"{[row[0] for row in geometry]} (bytes after the "
                         f"header offset)")
    _, beta, overlap = geometry[0]
    plan = plan_blocks(length, beta=beta, overlap=overlap)
    spans = [shard_plan(plan, j, d) for j in range(d)]
    # one capacity on every rank (the exchange needs equal buffers); spans
    # are balanced to within one block, so this pads by one block at most
    e_per = max(max(s.num_blocks for s in spans), 1) * plan.edge_cap
    loader._guard_int32_cap(path, e_per)
    span = spans[k]

    def load_one():
        if span.num_blocks == 0:
            # a mesh wider than the plan: all padding, still on the device
            return make_accumulators(e_per, weighted=weighted, device=dev)
        source = codecs.open_shard_block_source(path, plan, span, offset)
        out = loader._parse_span(
            source, plan, span.block_lo, span.block_hi, weighted=weighted,
            base=base, batch_blocks=batch_blocks, cap=e_per, device=dev,
            describe=getattr(source, "_describe", path), prefetch=False)
        source.finish()
        return out

    def load_with_recovery():
        attempts = faults.SHARD_RETRIES + 1
        fault_log: List[str] = []
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            for attempt in range(attempts):
                try:
                    s, dd, w, total = load_one()
                    # read on this thread: the buffers are complete when
                    # the caller's thread gets them
                    return (s, dd, w, int(total),
                            loader._device_num_vertices(s, dd) - 1)
                except (OSError, faults.StageTimeout) as exc:
                    transient = (faults.is_transient(exc)
                                 or isinstance(exc, faults.StageTimeout))
                    fault_log.append(
                        f"attempt {attempt + 1}: {type(exc).__name__}: "
                        f"{exc}")
                    if not transient or attempt + 1 >= attempts:
                        raise faults.ShardLoadError(
                            f"{path}: shard {k}/{d} failed loading byte "
                            f"span [{span.byte_lo}, {span.byte_hi}) after "
                            f"{attempt + 1} attempt(s):\n  "
                            + "\n  ".join(fault_log),
                            shard=k, fault_log=fault_log) from exc
                    faults._count("shard_retries")

    part, error = None, None
    # not a with-block: a stuck shard thread is abandoned, never joined
    pool = ThreadPoolExecutor(1, thread_name_prefix="shard-load")
    try:
        part = pool.submit(load_with_recovery).result(
            timeout=faults.WATCHDOG_S)
    except _FutTimeout:
        faults._count("stage_timeouts")
        error = faults.StageTimeout(
            f"{path}: shard {k}/{d} produced nothing within the "
            f"{faults.WATCHDOG_S:.1f}s watchdog budget (REPRO_WATCHDOG_S) "
            f"for byte span [{span.byte_lo}, {span.byte_hi}); the shard "
            f"thread is stuck")
    except Exception as exc:     # reported to every rank, then re-raised
        error = exc
    finally:
        pool.shutdown(wait=False, cancel_futures=True)

    mine = [0, 0, -1] if error is not None else [1, part[3], part[4]]
    table = _all_gather(torch.tensor(mine, dtype=torch.int64, device=dev),
                        group, d).tolist()
    if error is not None:
        raise error
    failed = [j for j, (ok, _, _) in enumerate(table) if not ok]
    if failed:
        raise faults.ShardLoadError(
            f"{path}: shard(s) {failed} of {d} failed loading their byte "
            f"spans; shard {k} loaded its own, and the load stops on every "
            f"rank (the failed rank's error carries its fault log)",
            shard=failed[0])
    counts = [int(c) for _, c, _ in table]
    max_id = max(int(m) for _, _, m in table)
    return part[0], part[1], part[2], counts, max_id


def bucket_histogram(mesh, axis: str, src: torch.Tensor, *, num_shards: int,
                     rows_per_shard: int,
                     edge_limit: Optional[int] = None) -> np.ndarray:
    """``(sender, owner)`` edge counts over every rank's ``src`` buffer,
    the bucket sizes the exchange will see: one local count per rank, then
    an ``all_gather``; every rank gets the ``(d, d)`` table, from which
    :func:`load_csr_sharded_stream` sizes ``send_cap``.  ``edge_limit``
    bounds the scan as in :func:`load_csr_sharded`."""
    group, d, _k = _axis(mesh, axis)
    s = src if edge_limit is None else src[:edge_limit]
    owner = torch.where(s >= 0, _owner(s, rows_per_shard),
                        num_shards).clamp(max=num_shards)
    cnt = torch.bincount(owner.long(), minlength=num_shards + 1)
    row = cnt[:num_shards].to(I32)
    return _all_gather(row, group, d).cpu().numpy()


def load_csr_sharded_stream(mesh, axis: str, path: str, *,
                            num_vertices: Optional[int] = None,
                            weighted: bool = False, base: int = 1,
                            rho: int = 4, method: str = "staged",
                            bin_bits: Optional[int] = None, offset: int = 0,
                            send_cap: Optional[int] = None,
                            beta: Optional[int] = None,
                            overlap: Optional[int] = None,
                            batch_blocks: Optional[int] = None) -> CSR:
    """File -> this rank's rows of the CSR sharded on ``axis``, every stage
    sharded: :func:`stream_shards`, then :func:`load_csr_sharded`.  The
    parsed edges stay on their devices from the accumulators to the CSR.

    ``send_cap=None`` sizes the exchange from the measured bucket counts
    (:func:`bucket_histogram`, rounded up on :func:`_cap_round`'s ladder)
    instead of the worst case, so receive buffers and the local build
    shrink from O(E) to O(E/d) on well-spread graphs; the same ladder
    bounds the valid-edge prefix each rank scans.  An overflow of a
    hand-passed ``send_cap`` still raises on every rank."""
    src, dst, w, counts, max_id = stream_shards(
        mesh, axis, path, weighted=weighted, base=base, offset=offset,
        beta=beta, overlap=overlap, batch_blocks=batch_blocks)
    if num_vertices is None:
        num_vertices = max_id + 1
    _group, d, _k = _axis(mesh, axis)
    rows = max(-(-num_vertices // d), 1)
    e_per = src.shape[0]
    edge_limit = min(e_per, _cap_round(max(counts, default=0)))
    if send_cap is None:
        peak = int(bucket_histogram(mesh, axis, src, num_shards=d,
                                    rows_per_shard=rows,
                                    edge_limit=edge_limit).max())
        send_cap = _cap_round(peak)
    return load_csr_sharded(mesh, axis, src, dst, w,
                            num_vertices=num_vertices, rho=rho,
                            method=method, bin_bits=bin_bits,
                            send_cap=send_cap, edge_limit=edge_limit)


def host_shard_and_load(mesh, axis: str, path: str, *, num_vertices: int,
                        weighted: bool = False, base: int = 1,
                        rho: int = 4) -> CSR:
    """The reference's historical entry point, an alias of
    :func:`load_csr_sharded_stream` (each rank streams its own span on its
    device).  Prefer ``GraphSource.csr_sharded(mesh)``."""
    return load_csr_sharded_stream(
        mesh, axis, path, num_vertices=num_vertices, weighted=weighted,
        base=base, rho=rho)
