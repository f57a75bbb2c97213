"""GraphSource: the lazy front door of the port.

The port of ``repro/core/source.py`` for text edgelists, raw or gzip::

    from repro_torch import open_graph
    src = open_graph("web.el")        # sniff the codec once; CUDA device
    src.info()                        # header-only probe, no parse
    src.csr()                         # lazy, memoized CSR on the card
    src.edgelist()                    # lazy, memoized EdgeList on the card

    src.csr(rows=(lo, hi))            # row-local slice of the CSR
    src.neighbors(u), src.degree(u)   # point reads

``device=None`` resolves to CUDA at open and raises without a CUDA
device; ``device="cpu"`` runs the plain PyTorch versions.  MTX, ``.gvel``
snapshots, framed containers, ``save`` and ``csr_sharded`` raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import zlib
from typing import Dict, Optional, Tuple

from .codecs import FRAMED_NOT_PORTED, compression_of, gzip_length_hint
from .env import resolve_device
from .loader import (DEFAULT_CSR_ENGINE, DEFAULT_EDGELIST_ENGINE, LoadOptions,
                     available_engines, get_engine, read_csr_via,
                     read_edgelist_via)
from .types import CSR, EdgeList

FORMAT_TEXT = "text"

_MTX_BANNER = b"%%MatrixMarket"
_GVEL_MAGIC = b"GVELSNAP"

_FRONT_DOOR_ITEM = ("ROADMAP Queue 1 item 6 (framed codecs, .gvel "
                    "snapshots, the front door's remaining products)")
_SHARDED_ITEM = "ROADMAP Queue 1 item 8 (the sharded load)"


def _not_ported(what: str, item: str = _FRONT_DOOR_ITEM):
    return NotImplementedError(f"{what} is not ported yet: {item}")


def _peek(path: str, n: int, kind: Optional[str]) -> bytes:
    """First ``n`` uncompressed bytes (b"" when unreadable)."""
    try:
        with (gzip.open(path, "rb") if kind == "gzip"
              else open(path, "rb")) as f:
            return f.read(n)
    except (OSError, EOFError, zlib.error):
        return b""


def _detect(path: str, offset: int) -> Optional[str]:
    """The compression kind of a text input; refuses the formats the port
    does not read yet."""
    kind = compression_of(path)
    if kind == "framed":
        raise NotImplementedError(f"{path}: {FRAMED_NOT_PORTED}")
    if offset == 0:
        head = _peek(path, len(_MTX_BANNER), kind)
        if head.startswith(_GVEL_MAGIC):
            raise _not_ported(f"{path}: reading .gvel snapshots")
        if head == _MTX_BANNER:
            raise _not_ported(f"{path}: reading MatrixMarket files")
    return kind


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
    """Cheap metadata about a text graph file -- no parse.  Plain text has
    no header, so ``num_vertices``/``num_edges`` are None; ``raw_bytes``
    is the uncompressed size when known (gzip trailer hint)."""

    path: str
    format: str
    codec: Optional[str]
    size_bytes: int
    raw_bytes: Optional[int]
    num_vertices: Optional[int]
    num_edges: Optional[int]
    weighted: Optional[bool]
    engine: Optional[str]
    device: str


class GraphSource:
    """A lazy handle on one text graph file; products are computed on first
    request and memoized on the handle (``src.csr() is src.csr()``)."""

    def __init__(self, path: str, opts: LoadOptions, *, validate: bool = True):
        self.path = str(path)
        self._ckind = _detect(self.path, opts.offset)
        self.options = opts.replace(device=resolve_device(opts.device))
        self.format = FORMAT_TEXT
        self._info: Optional[SourceInfo] = None
        self._el: Optional[EdgeList] = None
        self._csrs: Dict[Tuple[str, int, Optional[int]], CSR] = {}
        if validate:
            os.stat(self.path)
            if self.options.engine is not None:
                get_engine(self.options.engine)

    def __repr__(self) -> str:
        codec = f", codec={self._ckind}" if self._ckind else ""
        return (f"GraphSource({self.path!r}, format={self.format}{codec}, "
                f"engine={self.options.engine or 'auto'}, "
                f"device={self.options.device})")

    def _opts_for(self, product: str) -> LoadOptions:
        engine = self.options.engine or (
            DEFAULT_EDGELIST_ENGINE if product == "edgelist"
            else DEFAULT_CSR_ENGINE)
        return self.options.replace(engine=engine,
                                    weighted=bool(self.options.weighted))

    def info(self) -> SourceInfo:
        """Header-only metadata probe; memoized."""
        if self._info is None:
            raw = os.path.getsize(self.path)
            if self._ckind == "gzip":
                try:
                    raw = gzip_length_hint(self.path)
                except ValueError:
                    raw = None
            self._info = SourceInfo(
                path=self.path, format=self.format, codec=self._ckind,
                size_bytes=os.path.getsize(self.path), raw_bytes=raw,
                num_vertices=None, num_edges=None, weighted=None,
                engine=self.options.engine, device=str(self.options.device))
        return self._info

    def edgelist(self) -> EdgeList:
        """The graph as an :class:`EdgeList` on the source's device."""
        if self._el is None:
            self._el = read_edgelist_via(self.path, self._opts_for("edgelist"))
        return self._el

    def csr(self, *, method: Optional[str] = None, rho: int = 4,
            bin_bits: Optional[int] = None, rows=None) -> CSR:
        """The graph as a :class:`CSR` on the source's device; computed on
        first call per ``(method, rho, bin_bits)``.  ``method=None``
        resolves to the handle's method, then ``staged``.

        ``rows`` (a step-1 ``range`` or a ``(lo, hi)`` pair) returns the
        row-local slice of that (memoized) CSR, as :func:`slice_csr`;
        slices are not memoized."""
        method = method or self.options.method or "staged"
        if bin_bits is None:
            bin_bits = self.options.bin_bits
        if rows is not None:
            lo, hi = _normalize_rows(rows)
            return slice_csr(self.csr(method=method, rho=rho,
                                      bin_bits=bin_bits), lo, hi)
        key = (method, rho, bin_bits)
        if key not in self._csrs:
            self._csrs[key] = read_csr_via(self.path, self._opts_for("csr"),
                                           method=method, rho=rho,
                                           bin_bits=bin_bits)
        return self._csrs[key]

    def stream(self, **kw):
        """Packed device edge buffers ``((src, dst, w, total), cap)`` --
        the build's feed.  Not memoized."""
        opts = self._opts_for("csr")
        eng = get_engine(opts.engine)
        if not hasattr(eng, "stream"):
            raise ValueError(f"engine {opts.engine!r} has no stream path; "
                             f"engines: {available_engines()}")
        return eng.stream(self.path, **{**opts.stream_kwargs(), **kw})

    def _row(self, u: int) -> Tuple[CSR, int, int]:
        full = self.csr()
        if not 0 <= u < full.num_rows:
            raise IndexError(f"{self.path}: vertex {u} outside "
                             f"[0, {full.num_rows})")
        lo, hi = full.offsets[u:u + 2].tolist()
        return full, lo, hi

    def neighbors(self, u: int, *, with_weights: bool = False):
        """Point read: vertex ``u``'s neighbor ids as a 1-D int32 tensor
        on the source's device (ids and weights as a pair with
        ``with_weights=True``), sliced from the memoized CSR."""
        u = int(u)
        if with_weights and not self.options.weighted:
            raise ValueError(
                f"{self.path}: with_weights=True but source is unweighted")
        full, lo, hi = self._row(u)
        ids = full.targets[lo:hi]
        if not with_weights:
            return ids
        return ids, full.weights[lo:hi]

    def degree(self, u: int) -> int:
        """Vertex ``u``'s out-degree, from two offsets of the memoized
        CSR (a Python int, as in the reference)."""
        _full, lo, hi = self._row(int(u))
        return hi - lo

    def save(self, out_path: str, **kw):
        raise _not_ported("GraphSource.save (.gvel snapshots)")

    def csr_sharded(self, *args, **kw):
        raise _not_ported("GraphSource.csr_sharded", _SHARDED_ITEM)


def open_graph(path: str, *, engine: Optional[str] = None,
               weighted: Optional[bool] = None, base: Optional[int] = None,
               offset: int = 0, validate: bool = True,
               symmetric: bool = False, num_vertices: Optional[int] = None,
               method: Optional[str] = None, bin_bits: Optional[int] = None,
               device=None, **engine_kw) -> GraphSource:
    """Open a text graph file (raw or gzip) as a lazy :class:`GraphSource`
    on ``device`` (default CUDA; raises without one unless
    ``device="cpu"``).  ``engine_kw`` carries the streaming geometry
    (``beta``, ``overlap``, ``batch_blocks``)."""
    opts = LoadOptions(engine=engine, weighted=weighted, symmetric=symmetric,
                       base=1 if base is None else base,
                       num_vertices=num_vertices, offset=offset,
                       method=method, bin_bits=bin_bits, device=device,
                       engine_kw=dict(engine_kw))
    return GraphSource(path, opts, validate=validate)
