"""GraphSource: the lazy front door of the port.

The port of ``repro/core/source.py``::

    from repro_torch import open_graph
    src = open_graph("web.gvel")      # sniff format and codec once; CUDA
    src.info()                        # header-only probe, no payload
    src.csr()                         # lazy, memoized CSR on the card;
                                      # reads only a snapshot's CSR sections
    src.edgelist()                    # lazy, memoized EdgeList on the card
    src.csr(rows=(lo, hi))            # row-local slice
    src.neighbors(u), src.degree(u)   # point reads
    src.save("web.z.gvel", compress="zlib:1")   # write once, load many

Formats are sniffed by magic, never by extension: ``.gvel`` snapshots
(v1 raw, v2 compressed sections), MatrixMarket files and text edgelists,
each raw, gzip or framed (zlib/zstd) except snapshots, which compress
inside the container.  ``device=None`` resolves to CUDA at open and raises
without a CUDA device; ``device="cpu"`` runs the plain PyTorch versions.
Products land on the source's device.

Laziness: ``info()`` reads headers only; ``csr()`` on a both-sections
compressed snapshot decodes only the CSR sections, an unweighted read
never decodes a weights section, and ``csr(rows=)`` / ``neighbors`` /
``degree`` on a CSR-embedded snapshot decode only the frames they touch.
Damage inside a compressed section surfaces at first access of a product
that needs it, as :class:`~.snapshot.SnapshotError`.

Every product of a handle runs under the handle's fault plan
(``open_graph(..., faults=plan)``, :mod:`.faults`).  A handle may be shared
by threads (the serving cache does so): a cold product is built once, under
the handle's lock, and published only when its device work is complete, so
a thread on another CUDA stream never reads a product still being built.

``csr_sharded(mesh)`` gives each rank of a ``DeviceMesh`` its rows of the
CSR (:mod:`.distributed`); ``open_graph(path, tune=True)`` fills unpinned
streaming geometry from the measured profile (:mod:`.tune`).

``python -m repro_torch.core.source <path> [--device cpu]`` prints
``info()`` as JSON.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from . import tracing
from .env import resolve_device
from .faults import fault_plan
from .loader import (DEFAULT_CSR_ENGINE, DEFAULT_EDGELIST_ENGINE, LoadOptions,
                     available_engines, csr_convert_engine, engine_for_load,
                     get_engine, read_csr_sharded_via, read_csr_via,
                     read_edgelist_via, resolve_tuned)
from .types import CSR, EdgeList

FORMAT_GVEL = "gvel"
FORMAT_MTX = "mtx"
FORMAT_TEXT = "text"


def _normalize_rows(rows) -> Tuple[int, int]:
    """``rows`` -> ``(lo, hi)``: a ``range`` with step 1 or a ``(lo, hi)``
    pair; bounds are checked against |V| downstream."""
    if isinstance(rows, range):
        if rows.step != 1:
            raise ValueError(f"rows must have step 1, got {rows!r}")
        return rows.start, max(rows.start, rows.stop)
    try:
        lo, hi = rows
    except (TypeError, ValueError):
        raise ValueError(
            f"rows must be a step-1 range or a (lo, hi) pair, "
            f"got {rows!r}") from None
    lo, hi = int(lo), int(hi)
    if hi < lo:
        raise ValueError(f"rows (lo, hi) must have lo <= hi, got {rows!r}")
    return lo, hi


def slice_csr(csr: CSR, lo: int, hi: int) -> CSR:
    """Vertex rows ``[lo, hi)`` of a global CSR as a row-local CSR on the
    same device: ``offsets`` rebased to 0, ``row_start=lo``, global
    ``num_vertices``; ``targets``/``weights`` are views of the CSR's."""
    if csr.row_start != 0:
        raise ValueError("slice_csr expects a global CSR (row_start == 0)")
    if not 0 <= lo <= hi <= csr.num_rows:
        raise IndexError(
            f"row range [{lo}, {hi}) outside [0, {csr.num_rows})")
    off = csr.offsets[lo:hi + 1]
    e_lo, e_hi = off[[0, -1]].tolist()
    w = None if csr.weights is None else csr.weights[e_lo:e_hi]
    return CSR(off - e_lo, csr.targets[e_lo:e_hi], w, csr.num_vertices,
               row_start=lo)


@dataclasses.dataclass(frozen=True)
class SourceInfo:
    """Cheap metadata about a graph file: headers only, no payloads.

    ``None`` means unknown without parsing (plain text has no header).
    For MTX, ``num_edges`` is the declared entry count (before symmetric
    expansion).  ``raw_bytes`` is the uncompressed payload size when a
    header declares it, else the on-disk size of a raw file.
    ``section_frames`` holds a compressed ``.gvel``'s frame count per
    section (empty for raw sections, None for other formats).  ``device``
    is where the source's products land.
    """

    path: str
    format: str                       # "gvel" | "mtx" | "text"
    codec: Optional[str]              # "gzip" / "framed-zlib" / section codec
    size_bytes: int                   # on-disk size
    raw_bytes: Optional[int]          # uncompressed size, when known
    version: Optional[int]            # .gvel container version
    num_vertices: Optional[int]
    num_edges: Optional[int]
    weighted: Optional[bool]
    symmetric: Optional[bool]         # MTX banner symmetry (None elsewhere)
    has_edgelist: Optional[bool]      # .gvel sections present
    has_csr: Optional[bool]
    engine: Optional[str]             # engine pinned at open (None = default)
    device: str
    section_frames: Optional[Dict[str, int]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _detect(path: str, offset: int) -> Tuple[str, Optional[str]]:
    """(format, compression-kind) by magic sniff, never extension.

    ``offset != 0`` means body bytes inside another container (an MTX
    body), so only the compression sniff applies.  Unreadable paths sniff
    as raw text; existence is ``validate``'s job."""
    from .codecs import compression_of, peek_bytes
    from .mtx import MTX_BANNER
    from .snapshot import MAGIC, is_snapshot

    kind = compression_of(path)
    if offset != 0:
        return FORMAT_TEXT, kind
    if is_snapshot(path):
        return FORMAT_GVEL, None
    if kind is not None and peek_bytes(path, len(MAGIC)) == MAGIC:
        # a whole-file-compressed snapshot would decode as text garbage;
        # .gvel v2 compresses inside the container
        raise ValueError(
            f"{path}: externally compressed .gvel snapshot; "
            f"decompress it, or save it again with internal section "
            f"compression (GraphSource.save(..., compress=...))")
    if peek_bytes(path, len(MTX_BANNER)) == MTX_BANNER:
        return FORMAT_MTX, kind
    return FORMAT_TEXT, kind


class GraphSource:
    """A lazy handle on one graph file; products are computed on first
    request, on the source's device, and memoized on the handle
    (``src.csr() is src.csr()``).  The handle never re-sniffs the file."""

    def __init__(self, path: str, opts: LoadOptions, *, validate: bool = True):
        # recorded while a profiler runs: this open and the products' builds
        self._trace = tracing.begin()
        with tracing.request(self._trace, "gvel.open"):
            self.path = str(path)
            fmt, ckind = _detect(self.path, opts.offset)
            if fmt == FORMAT_GVEL:
                # a text parser pointed at a binary snapshot would decode
                # garbage
                opts = opts.replace(engine="snapshot")
            self.options = opts.replace(device=resolve_device(opts.device))
            self.format = fmt
            self._ckind = ckind               # "gzip" | "framed" | None
            self._info: Optional[SourceInfo] = None
            self._el: Optional[EdgeList] = None
            self._el_engine: Optional[str] = None
            self._csrs: Dict[Tuple[str, int, Optional[int]], CSR] = {}
            self._sharded_csrs: Dict[Tuple[Any, str, int, str,
                                           Optional[int]], CSR] = {}
            self._mtx_hdr = None
            self._gvel_peek = None            # (version, flags, V, E, entries)
            self._framed_hdr = None           # codecs.FramedInfo
            self._snap = None                 # pinned lazy Snapshot (gvel)
            # cold builds run once per handle, whichever thread asks first
            self._build_lock = threading.RLock()
            if validate:
                self._validate()

    def __repr__(self) -> str:
        codec = f", codec={self._ckind}" if self._ckind else ""
        return (f"GraphSource({self.path!r}, format={self.format}{codec}, "
                f"engine={self.options.engine or 'auto'}, "
                f"device={self.options.device})")

    # -- open-time checks ----------------------------------------------------

    def _validate(self) -> None:
        """Existence, container headers, engine name, section codec ids;
        never a section payload."""
        os.stat(self.path)
        if self.options.engine is not None:
            get_engine(self.options.engine)
        if self.format == FORMAT_GVEL:
            from . import codecs
            from .snapshot import SnapshotError
            for sid, _code, _off, _n, codec_id, _raw in self._peek_gvel()[4]:
                if codec_id:
                    try:
                        codecs.codec_for_id(codec_id)
                    except ValueError as exc:
                        raise SnapshotError(
                            f"{self.path}: section {sid}: {exc}") from None
        elif self.format == FORMAT_MTX:
            self._mtx_header()
        elif self._ckind == "framed":
            self._framed_info()

    def _peek_gvel(self):
        if self._gvel_peek is None:
            from .snapshot import peek_table
            self._gvel_peek = peek_table(self.path)
        return self._gvel_peek

    def _mtx_header(self):
        if self._mtx_hdr is None:
            from .mtx import read_header
            self._mtx_hdr = read_header(self.path)
        return self._mtx_hdr

    def _framed_info(self):
        if self._framed_hdr is None:
            from .codecs import read_framed_header
            self._framed_hdr = read_framed_header(self.path)
        return self._framed_hdr

    # -- option resolution ---------------------------------------------------

    def _weighted(self) -> bool:
        """``weighted=None`` means what the file says."""
        if self.options.weighted is not None:
            return self.options.weighted
        if self.format == FORMAT_GVEL:
            from .snapshot import FLAG_WEIGHTED
            return bool(self._peek_gvel()[1] & FLAG_WEIGHTED)
        if self.format == FORMAT_MTX:
            return self._mtx_header().meta.weighted
        return False                          # text has no header to ask

    def _opts_for(self, product: str) -> LoadOptions:
        engine = self.options.engine or (
            DEFAULT_EDGELIST_ENGINE if product == "edgelist"
            else DEFAULT_CSR_ENGINE)
        return self.options.replace(engine=engine, weighted=self._weighted())

    # -- products ------------------------------------------------------------

    def info(self) -> SourceInfo:
        """Header-only metadata probe; memoized."""
        if self._info is not None:
            return self._info
        size = os.path.getsize(self.path)
        codec = self._external_codec_name()
        version = v = e = None
        weighted = symmetric = has_el = has_csr = None
        section_frames = None
        raw = size if codec is None else None
        if self.format == FORMAT_GVEL:
            from . import codecs
            from .snapshot import (FLAG_CSR, FLAG_EDGELIST, FLAG_WEIGHTED,
                                   section_frame_counts)
            version, flags, v, e, entries = self._peek_gvel()
            weighted = bool(flags & FLAG_WEIGHTED)
            has_el = bool(flags & FLAG_EDGELIST)
            has_csr = bool(flags & FLAG_CSR)
            raw = sum(entry[5] for entry in entries)
            ids = {entry[4] for entry in entries} - {0}
            if ids:
                names = []
                for cid in sorted(ids):
                    try:
                        names.append(codecs.codec_for_id(cid).name)
                    except ValueError:
                        names.append(f"id{cid}")
                codec = "+".join(names)
                section_frames = section_frame_counts(self.path)
        elif self.format == FORMAT_MTX:
            hdr = self._mtx_header()
            v, e = hdr.meta.num_vertices, hdr.meta.num_edges
            weighted, symmetric = hdr.meta.weighted, hdr.meta.symmetric
        if self._ckind == "framed":
            raw = self._framed_info().orig_len
        elif self._ckind == "gzip":
            from .codecs import gzip_length_hint
            try:
                raw = gzip_length_hint(self.path)
            except ValueError:
                raw = None
        self._info = SourceInfo(
            path=self.path, format=self.format, codec=codec,
            size_bytes=size, raw_bytes=raw, version=version,
            num_vertices=v, num_edges=e, weighted=weighted,
            symmetric=symmetric, has_edgelist=has_el, has_csr=has_csr,
            engine=self.options.engine, device=str(self.options.device),
            section_frames=section_frames)
        return self._info

    def _external_codec_name(self) -> Optional[str]:
        if self._ckind == "framed":
            return f"framed-{self._framed_info().codec.name}"
        return self._ckind                    # "gzip" or None

    def _request(self, name: str):
        """The root span of a product's cold build (:mod:`.tracing`)."""
        load = tracing.begin(self._trace)
        if load is not None:
            self._trace = load
        return tracing.request(load, name)

    def edgelist(self) -> EdgeList:
        """The graph as an :class:`EdgeList` on the source's device."""
        if self._el is None:
            with self._build_lock, fault_plan(self.options.faults), \
                    self._request("gvel.edgelist"):
                if self._el is None:
                    opts = self._opts_for("edgelist")
                    if self.format == FORMAT_MTX:
                        el = self._mtx_edgelist(opts)
                    else:
                        el = read_edgelist_via(self.path, opts)
                    self._el_engine = opts.engine
                    self._el = self._complete(el)
        return self._el

    def _complete(self, product):
        """``product`` once the device work that made it has finished: it
        was queued on this thread's current stream, and a memoized product
        is read by other threads on their own streams."""
        dev = self.options.device
        with tracing.span("gvel.complete"):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        return product

    def _build_method(self, method: Optional[str]) -> str:
        return method or self.options.method or "staged"

    def csr(self, *, method: Optional[str] = None, rho: int = 4,
            bin_bits: Optional[int] = None, rows=None) -> CSR:
        """The graph as a :class:`CSR` on the source's device; computed on
        first call per ``(method, rho, bin_bits)``.  ``method=None``
        resolves to the handle's method, then ``staged``.  A snapshot's
        embedded CSR is served as stored (the method does not apply).

        ``rows`` (a step-1 ``range`` or a ``(lo, hi)`` pair) returns a
        row-local CSR; on a CSR-embedded snapshot only the bytes (frames)
        the rows span are read, elsewhere the memoized CSR is sliced.
        Slices are not memoized."""
        method = self._build_method(method)
        if bin_bits is None:
            bin_bits = self.options.bin_bits
        if rows is not None:
            return self._csr_rows(rows, method=method, rho=rho,
                                  bin_bits=bin_bits)
        key = (method, rho, bin_bits)
        csr = self._csrs.get(key)
        if csr is None:
            with self._build_lock, fault_plan(self.options.faults), \
                    self._request("gvel.csr"):
                csr = self._csrs.get(key)
                if csr is None:
                    csr = self._complete(self._build_csr(method, rho,
                                                         bin_bits))
                    self._csrs[key] = csr
        return csr

    def _build_csr(self, method: str, rho: int,
                   bin_bits: Optional[int]) -> CSR:
        opts = self._opts_for("csr")
        if self.format == FORMAT_MTX:
            from .csr import convert_to_csr
            return convert_to_csr(self.edgelist(), method=method, rho=rho,
                                  bin_bits=bin_bits,
                                  engine=csr_convert_engine(opts.engine))
        return read_csr_via(
            self.path, opts, method=method, rho=rho, bin_bits=bin_bits,
            fallback_edgelist=lambda: self._edgelist_for(opts))

    def _selective_snap(self):
        """The pinned lazy snapshot when selective reads can serve this
        source (``.gvel``, no symmetric or offset transform, an embedded
        CSR, no conflicting ``num_vertices``), else None.  Pinned on the
        handle so its frame memo lives as long as the handle."""
        if (self.format != FORMAT_GVEL or self.options.symmetric
                or self.options.offset):
            return None
        snap = self._snap
        if snap is None:
            from .snapshot import read_snapshot
            with self._build_lock:
                if self._snap is None:
                    self._snap = read_snapshot(self.path, eager=False)
                snap = self._snap
        if not snap.has_csr:
            return None
        nv = self.options.num_vertices
        if nv is not None and int(nv) != snap.num_vertices:
            return None
        return snap

    def frame_cache_stats(self) -> Optional[dict]:
        """Decoded-frame memo counters of the pinned snapshot
        (:meth:`~.snapshot.Snapshot.frame_cache_stats`), or None when no
        snapshot is pinned."""
        snap = self._snap
        return None if snap is None else snap.frame_cache_stats()

    def _csr_rows(self, rows, *, method: str, rho: int,
                  bin_bits: Optional[int] = None) -> CSR:
        lo, hi = _normalize_rows(rows)
        with fault_plan(self.options.faults):
            snap = self._selective_snap()
            if snap is not None:
                return snap.csr_rows(lo, hi, weighted=self._weighted(),
                                     device=self.options.device)
        return slice_csr(self.csr(method=method, rho=rho, bin_bits=bin_bits),
                         lo, hi)

    def _row(self, u: int) -> Tuple[CSR, int, int]:
        full = self.csr()
        if not 0 <= u < full.num_rows:
            raise IndexError(f"{self.path}: vertex {u} outside "
                             f"[0, {full.num_rows})")
        lo, hi = full.offsets[u:u + 2].tolist()
        return full, lo, hi

    def neighbors(self, u: int, *, with_weights: bool = False):
        """Point read: vertex ``u``'s neighbor ids as a 1-D int32 tensor on
        the source's device (ids and weights as a pair with
        ``with_weights=True``).  On a CSR-embedded snapshot only the bytes
        of ``u``'s row are read (weights only when asked for); elsewhere
        the memoized CSR is sliced."""
        u = int(u)
        if with_weights and not self._weighted():
            raise ValueError(
                f"{self.path}: with_weights=True but source is unweighted")
        with fault_plan(self.options.faults):
            snap = self._selective_snap()
            if snap is not None:
                return snap.neighbors(u, weighted=bool(with_weights),
                                      device=self.options.device)
        full, lo, hi = self._row(u)
        ids = full.targets[lo:hi]
        if not with_weights:
            return ids
        return ids, full.weights[lo:hi]

    def degree(self, u: int) -> int:
        """Vertex ``u``'s out-degree (a Python int, as in the reference);
        two offset elements on a CSR-embedded snapshot."""
        u = int(u)
        with fault_plan(self.options.faults):
            snap = self._selective_snap()
            if snap is not None:
                return snap.degree(u)
        _full, lo, hi = self._row(u)
        return hi - lo

    def csr_sharded(self, mesh, *, axis: str = "data", rho: int = 4,
                    method: Optional[str] = None,
                    bin_bits: Optional[int] = None) -> CSR:
        """This rank's rows of the CSR sharded across ``mesh`` (a
        ``torch.distributed`` ``DeviceMesh``) along ``axis``; every rank of
        the axis makes the call.  Computed on first call per ``(mesh, axis,
        rho, method, bin_bits)`` and memoized on the handle.

        Each rank streams only its byte span of the file
        (:func:`~.blocks.shard_plan`; a line belongs to the block holding
        its newline, so no edge is parsed twice) and the packed edges reach
        their owners in one ``all_to_all`` (:mod:`.distributed`).  The
        result is row-local: int32 offsets of ``rows = ceil(V/d)`` rows from
        ``row_start = k * rows``, and the receive-sized ``targets`` and
        ``weights``, on the mesh's device.  Only text edgelists
        shard this way: MTX raises (its banner applies to :meth:`csr`
        only), and so do ``.gvel`` snapshots (no text to split)."""
        if self.format == FORMAT_MTX:
            raise ValueError(
                f"{self.path}: csr_sharded() does not apply MTX banner "
                f"attributes; convert to a plain edgelist first or use "
                f".csr()")
        if self.format == FORMAT_GVEL:
            raise ValueError(
                f"{self.path}: .gvel snapshots are already parsed — "
                f"byte-range sharded streaming applies to text "
                f"edgelists; use .csr() and shard the result, or keep "
                f"the original text file for sharded loads")
        method = self._build_method(method)
        if bin_bits is None:
            bin_bits = self.options.bin_bits
        key = (mesh, axis, int(rho), method, bin_bits)
        csr = self._sharded_csrs.get(key)
        if csr is None:
            with self._build_lock, fault_plan(self.options.faults):
                csr = self._sharded_csrs.get(key)
                if csr is None:
                    csr = self._complete(read_csr_sharded_via(
                        self.path, self._opts_for("csr"), mesh=mesh,
                        axis=axis, rho=rho, method=method,
                        bin_bits=bin_bits))
                    self._sharded_csrs[key] = csr
        return csr

    def _edgelist_for(self, opts: LoadOptions) -> EdgeList:
        """EdgeList through ``opts.engine``, sharing the memo when the
        engines coincide.  Without a memo, a host engine's edge list is
        read on the CPU and not memoized: its CSR builds there, and only
        the CSR moves to the source's device."""
        if self._el is not None and self._el_engine == opts.engine:
            return self._el
        if csr_convert_engine(opts.engine) == "numpy":
            return read_edgelist_via(
                self.path, opts.replace(device=torch.device("cpu")))
        el = self._complete(read_edgelist_via(self.path, opts))
        if self._el is None:
            self._el_engine = opts.engine
            self._el = el
        return el

    def _mtx_edgelist(self, opts: LoadOptions) -> EdgeList:
        from .mtx import read_mtx
        hdr = self._mtx_header()
        if opts.weighted and not hdr.meta.weighted:
            raise ValueError(
                f"{self.path}: weighted load requested but the MTX field "
                f"is 'pattern' (no weight column)")
        if (opts.num_vertices is not None
                and opts.num_vertices != hdr.meta.num_vertices):
            raise ValueError(
                f"{self.path}: num_vertices={opts.num_vertices} conflicts "
                f"with the MTX size line ({hdr.meta.num_vertices})")
        el = read_mtx(self.path, engine=opts.engine, device=opts.device,
                      **opts.engine_kw)
        if el.weights is not None and not opts.weighted:
            el = EdgeList(el.src, el.dst, None, el.num_edges, el.num_vertices)
        if opts.symmetric and not hdr.meta.symmetric:
            from .edgelist import symmetrize
            el = symmetrize(el)
        return el

    def stream(self, **kw):
        """Packed device edge buffers ``((src, dst, w, total), cap)``, the
        build's feed (exact-length for a snapshot).  Not memoized.  MTX
        raises: its banner applies to ``edgelist()`` and ``csr()`` only."""
        if self.format == FORMAT_MTX:
            raise ValueError(
                f"{self.path}: stream() does not apply MTX banner "
                f"attributes; use .edgelist() or .csr()")
        opts = resolve_tuned(self._opts_for("csr"))
        with engine_for_load(opts.engine) as eng, fault_plan(opts.faults):
            if not hasattr(eng, "stream"):
                streaming = [n for n in available_engines()
                             if hasattr(get_engine(n), "stream")]
                raise ValueError(
                    f"engine {opts.engine!r} has no stream fast path; "
                    f"streaming engines: {streaming}")
            return eng.stream(self.path, **{**opts.stream_kwargs(), **kw})

    # -- write path ----------------------------------------------------------

    def save(self, out_path: str, *, compress: Optional[str] = None,
             compress_level: Optional[int] = None, csr: bool = True,
             method: Optional[str] = None, rho: int = 4) -> "GraphSource":
        """Write this graph as a ``.gvel`` snapshot and return a handle on
        the output, on the same device.  ``compress`` takes a codec spec
        (``"zlib"``, ``"zstd:9"``); ``csr=False`` stores only the edgelist.
        Memoized products are reused; a text source is parsed once (its
        CSR is built from the edgelist just read)."""
        with fault_plan(self.options.faults):
            return self._save(out_path, compress=compress,
                              compress_level=compress_level, csr=csr,
                              method=method, rho=rho)

    def _save(self, out_path: str, *, compress: Optional[str],
              compress_level: Optional[int], csr: bool,
              method: Optional[str], rho: int) -> "GraphSource":
        from .snapshot import SnapshotError, save_snapshot
        method = self._build_method(method)
        if compress is not None:
            from .codecs import parse_codec_spec
            codec, level = parse_codec_spec(compress)
            compress = codec.name
            if compress_level is None:
                compress_level = level
        if self.format == FORMAT_GVEL and not self.info().has_edgelist:
            if not csr:
                raise SnapshotError(
                    f"{self.path}: csr=False requested but this CSR-only "
                    f"snapshot has no edgelist sections to save")
            el, csr_obj = None, self.csr()    # CSR-only snapshots re-save
        else:
            el = self.edgelist()
            csr_obj = None
            if csr:
                key = (method, rho, self.options.bin_bits)
                with self._build_lock:
                    if self.format == FORMAT_TEXT and key not in self._csrs:
                        from .csr import convert_to_csr
                        self._csrs[key] = self._complete(convert_to_csr(
                            el, method=method, rho=rho,
                            bin_bits=self.options.bin_bits,
                            engine=csr_convert_engine(
                                self._opts_for("csr").engine)))
                csr_obj = self.csr(method=method, rho=rho)
        save_snapshot(out_path, edgelist=el, csr=csr_obj, compress=compress,
                      compress_level=compress_level)
        return GraphSource(out_path, LoadOptions(device=self.options.device),
                           validate=True)


def open_graph(path: str, *, engine: Optional[str] = None,
               weighted: Optional[bool] = None, base: Optional[int] = None,
               offset: int = 0, validate: bool = True,
               symmetric: bool = False, num_vertices: Optional[int] = None,
               method: Optional[str] = None, bin_bits: Optional[int] = None,
               device=None, tune: bool = False, faults=None,
               **engine_kw) -> GraphSource:
    """Open a graph file as a lazy :class:`GraphSource` on ``device``
    (default CUDA; raises without one unless ``device="cpu"``).

    Format (``.gvel`` / MTX / text) and compression (gzip / framed) are
    sniffed by magic here, once; ``.gvel`` files always route to the
    snapshot engine.  ``weighted=None`` means what the file says (snapshot
    flags, MTX banner; False for text).  ``base=None`` is the 1-based text
    convention (snapshots are 0-based and ignore it).  ``symmetric=True``
    appends every edge's reverse.  ``validate=True`` runs cheap structural
    checks at open, never touching section payloads.  ``engine_kw`` carries
    the streaming geometry (``beta``, ``overlap``, ``batch_blocks``).
    ``faults`` pins a :class:`~.faults.FaultPlan` on the handle: every
    product runs under it.  ``tune=True`` fills the streaming geometry not
    pinned in ``engine_kw`` from the measured profile of this host and
    device (:mod:`.tune`; the first use sweeps and keeps the winner)."""
    opts = LoadOptions(engine=engine, weighted=weighted, symmetric=symmetric,
                       base=1 if base is None else base,
                       num_vertices=num_vertices, offset=offset, tune=tune,
                       method=method, bin_bits=bin_bits, device=device,
                       faults=faults, engine_kw=dict(engine_kw))
    return GraphSource(path, opts, validate=validate)


def _main(argv: Optional[list] = None) -> int:
    """``python -m repro_torch.core.source <path> [path ...]``: print
    ``info()`` for each path as JSON (one object, or a list)."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.source",
        description="Probe graph files: print GraphSource.info() as JSON")
    ap.add_argument("paths", nargs="+", help="graph files (.el/.mtx/.gvel, "
                    "raw or compressed)")
    ap.add_argument("--device", default=None,
                    help="the products' device (default: CUDA)")
    args = ap.parse_args(argv)
    out, failed = [], False
    for p in args.paths:
        try:
            out.append(open_graph(p, device=args.device).info().to_dict())
        except (OSError, ValueError, RuntimeError) as exc:
            out.append({"path": p, "error": str(exc)})
            failed = True
    print(json.dumps(out[0] if len(out) == 1 else out, indent=2))
    if failed:
        print("probe failed for one or more paths", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
