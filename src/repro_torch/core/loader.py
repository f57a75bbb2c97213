"""Streaming loader on the card: the engine registry and engine calls.

The port of ``repro/core/loader.py``, with the reference's engine table:

    ==========  ================================================
    engine      implementation
    ==========  ================================================
    device      the streaming pipeline below, on the card
    pallas      the same engine under the reference's name for its
                Pallas parse (the card's parse is that kernel's port)
    numpy       the single-pass vectorized numpy parser (host)
    threads     the same parse on a thread pool (host)
    snapshot    ``.gvel`` files (:mod:`.snapshot`)
    ==========  ================================================

The streaming engine parses a text edgelist (raw, gzip or framed) into
packed device accumulators and hands them to the rank-based CSR builders:

  1. a prefetch thread stages batch i+1's overlap-padded blocks as one
     flat span into a :class:`~repro_torch.core.blocks.StagingArena` ring
     (pinned on CUDA; gzip and framed decompression run in that thread
     too; a framed file's frames are the blocks) while
     the card parses batch i;
  2. the consumer copies the span host-to-device with ``non_blocking=True``
     on a side stream and records an event; the parse stream waits on the
     event, and the arena slot is fenced with it, so the prefetch thread
     never refills a slot whose copy is still in flight;
  3. each batch runs the fused ``parse_accumulate`` kernel over the span
     (rows ``beta`` apart), which parses it and packs its edges into the
     accumulators at the device-resident running total
     (``parse.parse_accumulate``), with no host sync; the short tail batch
     is parsed at its own size;
  4. the host syncs once for the edge count and once for the vertex
     count and builds the CSR of the first n slots on the card
     (``build.csr_staged`` by default, which sorts in the accumulators).

Under a running ``torch.profiler`` each step is a span of :mod:`.tracing`
(``gvel.setup``; a ``gvel.batch`` a batch holding ``gvel.wait``,
``gvel.h2d`` and ``gvel.parse``; the prefetch thread's ``gvel.stage``;
``gvel.sync`` and ``gvel.build``) with the load's counters.

The host engines (:mod:`.edgelist`) parse on the CPU and, for ``csr()``,
build there too (``csr_convert_engine``), as the paper and the reference
do; the product moves to its device once, at the end.  A host engine runs
only when the caller names it.

Entry points resolve ``device=None`` to CUDA and raise without one; pass
``device="cpu"`` to run the plain PyTorch versions.
"""
from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import (Any, Callable, Dict, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from . import build, faults, tracing
from .blocks import StagingArena, flat_len, owned_range, plan_blocks
from .env import resolve_device
from .parse import make_accumulators, parse_accumulate
from .types import CSR, EdgeList

DEFAULT_EDGELIST_ENGINE = "device"
DEFAULT_CSR_ENGINE = "device"
HOST_ENGINES = ("numpy", "threads")      # parse and build on the host

# GVEL's paper geometry
DEFAULT_BETA = 256 * 1024
DEFAULT_BATCH_BLOCKS = 8
DEFAULT_OVERLAP = 64


@dataclasses.dataclass(frozen=True)
class LoadOptions:
    """The normalized loading knobs, expanded once into every engine call.

    ``engine=None`` means the default (``device``); ``weighted=None``
    means what the file says (snapshot flags, MTX banner; False for text);
    ``device=None`` means CUDA.  ``symmetric=True`` appends every edge's
    reverse (the front door does it once, on the device).  ``engine_kw``
    carries an engine's knobs verbatim: the streaming geometry (``beta``,
    ``overlap``, ``batch_blocks``), ``num_workers`` and
    ``chunks_per_worker`` for ``threads``, ``chunk_bytes`` and
    ``num_chunks`` for ``numpy``.  ``tune=True`` fills the streaming geometry
    the caller did not pin from the measured profile of this host and
    device (:mod:`.tune`; the first use sweeps); other engines ignore it.
    ``faults`` pins a :class:`~.faults.FaultPlan` on the handle: every
    product runs under it (never expanded into engine keywords).
    """

    engine: Optional[str] = None
    weighted: Optional[bool] = None
    symmetric: bool = False
    base: int = 1
    num_vertices: Optional[int] = None
    offset: int = 0
    tune: bool = False
    method: Optional[str] = None
    bin_bits: Optional[int] = None
    device: Any = None
    faults: Any = None
    engine_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)

    _OWN_FIELDS = ("engine", "weighted", "symmetric", "base",
                   "num_vertices", "offset", "tune", "method", "bin_bits",
                   "device", "faults")

    def __post_init__(self):
        if self.base not in (0, 1):
            raise ValueError(f"base must be 0 or 1, got {self.base!r}")
        if self.offset < 0:
            raise ValueError(f"offset must be >= 0, got {self.offset!r}")
        if self.method not in (None, "global", "staged", "binned"):
            raise ValueError(f"unknown method {self.method!r}; expected "
                             f"'global', 'staged' or 'binned'")
        dup = sorted(set(self.engine_kw) & set(self._OWN_FIELDS))
        if dup:
            raise ValueError(f"option(s) {dup} passed both named and via "
                             f"engine_kw")

    def replace(self, **changes) -> "LoadOptions":
        return dataclasses.replace(self, **changes)

    def read_kwargs(self) -> Dict[str, Any]:
        """Keywords for an engine's ``read_edgelist``."""
        return dict(self.engine_kw, weighted=bool(self.weighted),
                    base=self.base, num_vertices=self.num_vertices,
                    offset=self.offset, device=self.device)

    def stream_kwargs(self) -> Dict[str, Any]:
        """Keywords for an engine's ``stream``."""
        return dict(self.engine_kw, weighted=bool(self.weighted),
                    base=self.base, offset=self.offset, device=self.device)

    def prebuilt_kwargs(self) -> Dict[str, Any]:
        """Keywords for an engine's ``read_csr_prebuilt``."""
        return dict(self.engine_kw, weighted=bool(self.weighted),
                    num_vertices=self.num_vertices, offset=self.offset,
                    device=self.device)


# (src, dst, weights-or-None, num_edges device scalar): packed device
# buffers with -1 padding past num_edges (none from a snapshot)
DeviceEdges = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
                    torch.Tensor]


@runtime_checkable
class LoaderEngine(Protocol):
    """A parse backend for :func:`register_engine`.  ``read_edgelist`` is
    mandatory; an engine that leaves edges on the device also implements
    ``stream`` (``read_csr_via`` probes for it, and for
    ``read_csr_prebuilt`` and ``num_vertices_hint``, with ``hasattr``)."""

    name: str

    def read_edgelist(self, path: str, *, weighted: bool, base: int,
                      num_vertices: Optional[int], offset: int,
                      **kw) -> EdgeList: ...


_REGISTRY: Dict[str, Any] = {}


def register_engine(engine):
    """Register an engine instance under ``engine.name`` (last wins)."""
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown loader engine {name!r}; available: {available_engines()}"
        ) from None


def available_engines() -> list:
    """The registered engines' names: the reference's ``device``,
    ``pallas``, ``numpy``, ``threads`` and ``snapshot``.  ``pallas`` is the
    streaming engine under a second name: its parse is the hand-written
    port of the reference's Pallas parse kernel, as ``device``'s is."""
    return sorted(_REGISTRY)


def csr_convert_engine(engine: str) -> str:
    """The ``convert_to_csr`` backend for a loader engine: the host
    engines keep the host build, every other engine builds on its
    product's device."""
    return "numpy" if engine in HOST_ENGINES else "device"


@contextlib.contextmanager
def engine_for_load(name: str):
    """``get_engine(name)`` for one load: what the engine memoized during
    the load (the snapshot engine's open file) is let go when it ends, so
    a finished load pins no file."""
    eng = get_engine(name)
    try:
        yield eng
    finally:
        release = getattr(eng, "clear_memo", None)
        if release is not None:
            release()


# ---------------------------------------------------------------------------
# streaming pipeline
# ---------------------------------------------------------------------------

def _guard_int32_cap(path: str, cap: int) -> None:
    """Accumulator positions are int32; refuse capacities that would wrap."""
    if cap > np.iinfo(np.int32).max:
        raise ValueError(
            f"{path}: edge capacity {cap} exceeds int32 indexing for the "
            f"streaming engine; use engine='numpy'/'threads' or shard the "
            f"file (GraphSource.csr_sharded)")


class _DeviceFeed:
    """Host spans -> device spans on a side stream, over a ring of device
    buffers.  A device slot is overwritten only after the parse that read
    it (its ``parsed`` event) has run."""

    def __init__(self, nbytes: int, device: torch.device, slots: int = 2):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.bufs = [torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                 device=device) for _ in range(slots)]
        self.parsed = [None] * slots

    def put(self, i: int, host: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        k = i % len(self.bufs)
        with torch.cuda.stream(self.stream):
            if self.parsed[k] is not None:
                self.stream.wait_event(self.parsed[k])
            dev = self.bufs[k][:host.numel()]
            dev.copy_(host, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(copied)
        return dev, copied

    def done(self, i: int) -> None:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.parsed[i % len(self.bufs)] = ev


def _parse_span(source, plan, block_lo: int, block_hi: int, *,
                weighted: bool, base: int, batch_blocks: int, cap: int,
                device: torch.device, describe: str = "block source",
                prefetch: bool = True) -> DeviceEdges:
    """Stage and parse blocks ``[block_lo, block_hi)`` of ``plan`` from
    ``source`` into fresh accumulators of ``cap`` slots on ``device``.

    ``prefetch=False`` stages each batch inline in the calling thread, as
    a shard of the sharded load does (each shard already runs in its own
    process); the card's parse of batch i still overlaps the staging of
    batch i+1, and each arena slot is fenced by its copy's event either
    way."""
    os_, oe = owned_range(plan)
    edge_cap = plan.edge_cap
    nspan = max(block_hi - block_lo, 0)
    num_batches = -(-nspan // batch_blocks)
    cuda = device.type == "cuda"
    at = tracing.here()         # the prefetch thread records into this load
    placed = 0                  # slots the windows so far may have used

    def batch_ids(i: int) -> np.ndarray:
        start = block_lo + i * batch_blocks
        return np.arange(start, min(start + batch_blocks, block_hi))

    def stage(i: int) -> np.ndarray:
        ids = batch_ids(i)
        slot = arena.slot(i)
        with tracing.span("gvel.stage", at):
            flat = faults.call_with_retries(
                lambda: source.stage(plan, ids, arena=slot, check_lines=True),
                describe=f"{describe}: stage blocks "
                         f"[{int(ids[0])}, {int(ids[-1]) + 1})")
            tracing.count("bytes_staged", flat.nbytes)
        return flat

    def staged(i: int, fut) -> np.ndarray:
        """Batch ``i`` from the prefetch thread, within the watchdog."""
        try:
            return fut.result(timeout=faults.WATCHDOG_S)
        except _FutTimeout:
            faults._count("stage_timeouts")
            ids = batch_ids(i)
            lo_b = int(ids[0]) * plan.beta
            hi_b = min((int(ids[-1]) + 1) * plan.beta, plan.file_len)
            raise faults.StageTimeout(
                f"{describe}: staging of byte span [{lo_b}, {hi_b}) "
                f"(batch {i + 1}/{num_batches}) produced nothing "
                f"within the {faults.WATCHDOG_S:.1f}s watchdog "
                f"budget (REPRO_WATCHDOG_S); reader is stuck"
            ) from None

    def consume(i: int, flat: np.ndarray) -> None:
        nonlocal acc_src, acc_dst, acc_w, total, placed
        nb = len(batch_ids(i))
        edge_bound = nb * edge_cap
        if placed + edge_bound > cap:
            raise AssertionError(f"batch {i} window [{placed}, "
                                 f"{placed + edge_bound}) exceeds {cap}")
        placed += edge_bound
        with tracing.span("gvel.h2d"):
            span = torch.from_numpy(flat)
            if cuda:
                span, copied = feed.put(i, span)
                arena.fence(i, copied)
        with tracing.span("gvel.parse"):
            bufs = span.as_strided((nb, plan.buf_len), (plan.beta, 1))
            acc_src, acc_dst, acc_w, total = parse_accumulate(
                acc_src, acc_dst, acc_w, total, bufs, os_, oe,
                weighted=weighted, base=base, edge_bound=edge_bound)
            if cuda:
                feed.done(i)

    pool = None
    try:
        with tracing.span("gvel.setup"):
            acc_src, acc_dst, acc_w, total = make_accumulators(
                cap, weighted=weighted, device=device)
            if num_batches == 0:
                return acc_src, acc_dst, acc_w, total
            span_bytes = flat_len(min(batch_blocks, nspan), plan)
            arena = StagingArena(span_bytes, pin=cuda)
            feed = _DeviceFeed(span_bytes, device) if cuda else None
            if prefetch:
                # not a with-block: a stuck staging thread is abandoned
                # (shutdown(wait=False)), never joined
                pool = ThreadPoolExecutor(
                    1, thread_name_prefix="loader-prefetch")
                fut = pool.submit(stage, 0)
        for i in range(num_batches):
            with tracing.span("gvel.batch"):
                if pool is None:
                    flat = stage(i)
                else:
                    with tracing.span("gvel.wait"):
                        flat = staged(i, fut)
                    if i + 1 < num_batches:
                        fut = pool.submit(stage, i + 1)     # double buffer
                consume(i, flat)
        tracing.count("batches", num_batches)
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
    return acc_src, acc_dst, acc_w, total


def _stream_edges(path: str, *, weighted: bool, base: int, offset: int,
                  beta: int, overlap: int, batch_blocks: int,
                  device: torch.device) -> Tuple[DeviceEdges, int]:
    """File -> packed device edge buffers; returns ``((src, dst, w, total),
    capacity)``.  Capacity is GVEL's bytes-derived over-allocation (one
    window of ``edge_cap`` slots per block); lines longer than ``overlap``
    that cross a block boundary raise ``ValueError``.  A framed file
    forces ``beta`` to its frame size."""
    from .codecs import open_block_source
    with tracing.span("gvel.setup"):
        source, forced_beta = open_block_source(path, offset)
        if forced_beta is not None and forced_beta > overlap:
            beta = forced_beta          # one frame per block
        plan = plan_blocks(source.length, beta=beta, overlap=overlap)
        cap = plan.num_blocks * plan.edge_cap
        _guard_int32_cap(path, cap)
    edges = _parse_span(source, plan, 0, plan.num_blocks, weighted=weighted,
                        base=base, batch_blocks=batch_blocks, cap=cap,
                        device=device,
                        describe=getattr(source, "_describe", path))
    source.finish()
    return edges, cap


def _device_num_vertices(src: torch.Tensor, dst: torch.Tensor) -> int:
    """max id + 1 over the packed buffers (-1 padding never wins, and an
    empty buffer counts as -1)."""
    with tracing.span("gvel.sync"):
        m = torch.full((), -1, dtype=src.dtype, device=src.device)
        if src.numel():
            m = torch.maximum(m, src.max())
        if dst.numel():
            m = torch.maximum(m, dst.max())
        return int(m) + 1


def _edge_count(total: torch.Tensor) -> int:
    """The accumulators' running total on the host (a sync)."""
    with tracing.span("gvel.sync"):
        return int(total)


class _StreamingEngine:
    """The streaming pipeline above."""

    def __init__(self, name: str):
        self.name = name

    def stream(self, path: str, *, weighted: bool = False, base: int = 1,
               offset: int = 0, device=None, beta: Optional[int] = None,
               overlap: Optional[int] = None,
               batch_blocks: Optional[int] = None
               ) -> Tuple[DeviceEdges, int]:
        return _stream_edges(
            path, weighted=weighted, base=base, offset=offset,
            beta=DEFAULT_BETA if beta is None else beta,
            overlap=DEFAULT_OVERLAP if overlap is None else overlap,
            batch_blocks=(DEFAULT_BATCH_BLOCKS if batch_blocks is None
                          else batch_blocks),
            device=resolve_device(device))

    def read_edgelist(self, path: str, *, weighted: bool = False,
                      base: int = 1, num_vertices: Optional[int] = None,
                      offset: int = 0, device=None, **kw) -> EdgeList:
        (src, dst, w, total), _ = self.stream(
            path, weighted=weighted, base=base, offset=offset,
            device=device, **kw)
        n = _edge_count(total)
        if num_vertices is None:
            num_vertices = _device_num_vertices(src, dst)
        return EdgeList(src[:n], dst[:n], w[:n] if weighted else None, n,
                        num_vertices)


class _HostEngine:
    """Adapter around a host parser of :mod:`.edgelist`."""

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self._fn = fn

    def read_edgelist(self, path: str, *, weighted: bool = False,
                      base: int = 1, num_vertices: Optional[int] = None,
                      offset: int = 0, **kw) -> EdgeList:
        return self._fn(path, weighted=weighted, base=base,
                        num_vertices=num_vertices, offset=offset, **kw)


def _register_builtin_engines() -> None:
    from . import edgelist
    from .snapshot import SnapshotEngine
    register_engine(_StreamingEngine("device"))
    register_engine(_StreamingEngine("pallas"))
    register_engine(_HostEngine("numpy", edgelist.read_edgelist_numpy))
    register_engine(_HostEngine("threads", edgelist.read_edgelist_threads))
    register_engine(SnapshotEngine())


# ---------------------------------------------------------------------------
# engine-call implementations (shared by GraphSource and the wrappers)
# ---------------------------------------------------------------------------

def resolve_tuned(opts: LoadOptions, *, shards: int = 1) -> LoadOptions:
    """``opts`` with the streaming geometry the caller did not pin
    (``beta``, ``batch_blocks``) filled from the measured profile when
    ``opts.tune`` is set; the first tuned load on a host and device runs
    the sweep and keeps its winner (:func:`.tune.tuned_geometry`).  A no-op
    for engines without block geometry.  ``shards`` picks the sharded
    load's profile slot: d pipelines over 1/d of the bytes each have
    another throughput knee than one over all of them."""
    if not opts.tune or not isinstance(_REGISTRY.get(opts.engine),
                                       _StreamingEngine):
        return opts
    kw = dict(opts.engine_kw)
    if "beta" in kw and "batch_blocks" in kw:
        return opts
    from .tune import tuned_geometry
    g = tuned_geometry(weighted=bool(opts.weighted), shards=int(shards),
                       device=opts.device)
    kw.setdefault("beta", g["beta"])
    kw.setdefault("batch_blocks", g["batch_blocks"])
    return opts.replace(engine_kw=kw)


def read_edgelist_via(path: str, opts: LoadOptions) -> EdgeList:
    """File -> EdgeList through ``opts.engine`` (must be concrete).  The
    engines return the edges as stored; ``symmetric`` appends the reverse
    edges here, once."""
    opts = resolve_tuned(opts)
    with engine_for_load(opts.engine) as eng:
        el = eng.read_edgelist(path, **opts.read_kwargs())
    if opts.symmetric:
        from .edgelist import symmetrize
        el = symmetrize(el)
    return el


def read_csr_via(path: str, opts: LoadOptions, *,
                 method: Optional[str] = None, rho: int = 4,
                 bin_bits: Optional[int] = None,
                 fallback_edgelist: Optional[Callable[[], EdgeList]] = None,
                 ) -> CSR:
    """File -> CSR on the load's device through ``opts.engine``, trying in
    order: the engine's ``read_csr_prebuilt`` (no parse, no build), its
    ``stream`` + the build (one sync for the edge count, one for the vertex
    count unless known; the build reads exactly the n edges),
    then an EdgeList (``fallback_edgelist``, or a read) + ``convert_to_csr``
    by ``csr_convert_engine`` (a host engine builds on the host), the CSR
    moved to the load's device.  A symmetric load takes the last route.
    Offsets come back int64."""
    opts = resolve_tuned(opts)
    method = method or opts.method or "staged"
    bin_bits = bin_bits if bin_bits is not None else opts.bin_bits
    weighted = bool(opts.weighted)
    with engine_for_load(opts.engine) as eng:
        if hasattr(eng, "read_csr_prebuilt") and not opts.symmetric:
            csr = eng.read_csr_prebuilt(path, **opts.prebuilt_kwargs())
            if csr is not None:
                return csr
        if hasattr(eng, "stream") and not opts.symmetric:
            num_vertices = opts.num_vertices
            if num_vertices is None and hasattr(eng, "num_vertices_hint"):
                num_vertices = eng.num_vertices_hint(path)
            (src, dst, w, total), _cap = eng.stream(
                path, **opts.stream_kwargs())
            n = _edge_count(total)
            if num_vertices is None:
                num_vertices = _device_num_vertices(src, dst) if n else 0
            with tracing.span("gvel.build"):
                # the edges are the accumulators' first n slots, and the
                # accumulators are this load's own: the build may sort in
                # them (donate)
                offsets, targets, ww = build.build_csr(
                    src, dst, w, num_vertices, method=method, rho=rho,
                    bin_bits=bin_bits, weighted=weighted, num_edges=n,
                    donate=True)
                return CSR(offsets.to(torch.int64), targets,
                           ww if weighted else None, num_vertices)
    from .csr import convert_to_csr
    el = (fallback_edgelist() if fallback_edgelist is not None
          else read_edgelist_via(path, opts))
    return convert_to_csr(el, method=method, rho=rho, bin_bits=bin_bits,
                          engine=csr_convert_engine(opts.engine)).to(
                              resolve_device(opts.device))


def read_csr_sharded_via(path: str, opts: LoadOptions, *, mesh,
                         axis: str = "data", rho: int = 4,
                         method: Optional[str] = None,
                         bin_bits: Optional[int] = None) -> CSR:
    """File -> this rank's rows of the CSR sharded across ``mesh`` along
    ``axis`` (:func:`.distributed.load_csr_sharded_stream`): each rank
    streams its own byte span, and the edges reach their owners in one
    ``all_to_all``.  Only the streaming engine has a byte-range plan;
    ``tune=True`` resolves against the per-shard-count profile slot."""
    from . import distributed
    if opts.symmetric:
        raise ValueError(
            "sharded streaming load does not support symmetric=True "
            "(reverse-edge expansion is a host concatenation; load the "
            "CSR unsharded or pre-symmetrize the file)")
    if not isinstance(get_engine(opts.engine), _StreamingEngine):
        raise ValueError(
            f"engine {opts.engine!r} has no sharded streaming path; use a "
            f"streaming engine ('device' or 'pallas')")
    _group, d, _k = distributed._axis(mesh, axis)
    opts = resolve_tuned(opts, shards=d)
    kw = opts.stream_kwargs()
    dev = kw.pop("device")            # the mesh says where the rows live
    if dev is not None and torch.device(dev).type != mesh.device_type:
        raise ValueError(
            f"the load's device {dev} is not on the mesh's device type "
            f"{mesh.device_type!r}")
    return distributed.load_csr_sharded_stream(
        mesh, axis, path, num_vertices=opts.num_vertices, rho=rho,
        method=method or opts.method or "staged",
        bin_bits=bin_bits if bin_bits is not None else opts.bin_bits, **kw)


# ---------------------------------------------------------------------------
# front door (thin wrappers over repro_torch.core.source.open_graph)
# ---------------------------------------------------------------------------

def load_edgelist(path: str, *, engine: str = DEFAULT_EDGELIST_ENGINE,
                  weighted: bool = False, symmetric: bool = False,
                  base: int = 1, num_vertices: Optional[int] = None,
                  offset: int = 0, device=None, tune: bool = False,
                  **engine_kw) -> EdgeList:
    """File -> EdgeList on ``device`` (default CUDA); the same as
    ``open_graph(path, ...).edgelist()``.  ``.gvel`` files route to the
    snapshot engine whatever ``engine`` says; ``tune=True`` fills unpinned
    streaming geometry from the measured profile."""
    from .source import open_graph
    return open_graph(path, engine=engine, weighted=weighted,
                      symmetric=symmetric, base=base,
                      num_vertices=num_vertices, offset=offset,
                      device=device, tune=tune,
                      **engine_kw).edgelist()


def load_csr(path: str, *, engine: str = DEFAULT_CSR_ENGINE,
             weighted: bool = False, symmetric: bool = False, base: int = 1,
             num_vertices: Optional[int] = None, method: str = "staged",
             rho: int = 4, bin_bits: Optional[int] = None, offset: int = 0,
             device=None, tune: bool = False, **engine_kw) -> CSR:
    """File -> CSR on ``device`` (default CUDA); the same as
    ``open_graph(path, ...).csr(method=..., rho=..., bin_bits=...)``.  A
    ``.gvel`` file's embedded CSR is served as stored (``method`` does not
    apply); ``tune=True`` fills unpinned streaming geometry from the
    measured profile."""
    from .source import open_graph
    return open_graph(path, engine=engine, weighted=weighted,
                      symmetric=symmetric, base=base,
                      num_vertices=num_vertices, offset=offset,
                      device=device, tune=tune, **engine_kw).csr(
                          method=method, rho=rho, bin_bits=bin_bits)


_register_builtin_engines()
