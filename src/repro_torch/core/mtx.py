"""Matrix Market (MTX) files, honouring the banner, on the device.

The port of ``repro/core/mtx.py``::

    %%MatrixMarket matrix coordinate <field> <symmetry>
    % comments...
    <rows> <cols> <nnz>

``field`` real|integer|pattern (pattern: unweighted); ``symmetry``
general|symmetric (symmetric: the reverse of every non-loop entry is
appended, after all the stored entries, on the device).  The body is
parsed by the streaming loader at ``offset=body_offset``, in uncompressed
coordinates, so gzip and framed MTX files read the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .csr import convert_to_csr
from .types import CSR, EdgeList, GraphMeta, _np

MTX_BANNER = b"%%MatrixMarket"


@dataclasses.dataclass(frozen=True)
class MtxHeader:
    meta: GraphMeta
    body_offset: int          # byte offset of the first entry line
    rows: int
    cols: int


def read_header(path: str) -> MtxHeader:
    """Banner, comments and size line; ``body_offset`` is an uncompressed
    byte offset whatever the file's compression."""
    from .codecs import open_stream
    with open_stream(path) as f:
        banner = f.readline()
        if not banner.startswith(MTX_BANNER):
            raise ValueError(f"{path}: missing MatrixMarket banner")
        parts = banner.decode().strip().lower().split()
        if len(parts) < 5 or parts[1] != "matrix" or parts[2] != "coordinate":
            raise ValueError(f"{path}: unsupported banner {banner!r}")
        field, symmetry = parts[3], parts[4]
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path}: unsupported field {field!r}")
        if symmetry not in ("general", "symmetric"):
            raise ValueError(f"{path}: unsupported symmetry {symmetry!r}")
        line = f.readline()
        while line.startswith(b"%"):
            line = f.readline()
        rows, cols, nnz = (int(x) for x in line.split()[:3])
        body = f.tell()
    meta = GraphMeta(
        num_vertices=max(rows, cols),
        num_edges=nnz,
        weighted=field in ("real", "integer"),
        symmetric=symmetry == "symmetric",
        base=1,
        pattern=field == "pattern",
    )
    return MtxHeader(meta, body, rows, cols)


def _read_body(path: str, hdr: MtxHeader, engine: str, device=None,
               **kw) -> EdgeList:
    """The entries after the header, through the loader at
    ``offset=body_offset`` (the size line would parse as an edge)."""
    from .loader import load_edgelist
    return load_edgelist(path, engine=engine, weighted=hdr.meta.weighted,
                         base=1, num_vertices=hdr.meta.num_vertices,
                         offset=hdr.body_offset, device=device, **kw)


def read_mtx(path: str, *, engine: str = "device", device=None,
             **engine_kw) -> EdgeList:
    """An MTX file as an EdgeList on ``device`` (default CUDA), honouring
    field and symmetry: a symmetric file gets the reverse of each entry
    that is not a self-loop, appended in entry order."""
    hdr = read_header(path)
    el = _read_body(path, hdr, engine, device=device, **engine_kw)
    if int(el.num_edges) != hdr.meta.num_edges:
        raise ValueError(
            f"{path}: parsed {int(el.num_edges)} entries, header says "
            f"{hdr.meta.num_edges}")
    if hdr.meta.symmetric:
        n = int(el.num_edges)
        src, dst = el.src[:n], el.dst[:n]
        keep = src != dst                     # do not duplicate self-loops
        w = el.weights
        if w is not None:
            w = torch.cat([w[:n], w[:n][keep]])
        rs = dst[keep]
        el = EdgeList(torch.cat([src, rs]), torch.cat([dst, src[keep]]), w,
                      n + int(rs.shape[0]), el.num_vertices)
    return el


def read_mtx_csr(path: str, *, method: str = "staged", rho: int = 4,
                 engine: str = "device", device=None) -> CSR:
    """An MTX file as a CSR on ``device``; a host engine builds it on the
    host, as in the reference."""
    from .loader import csr_convert_engine
    return convert_to_csr(read_mtx(path, engine=engine, device=device),
                          method=method, rho=rho,
                          engine=csr_convert_engine(engine))


def mtx_to_snapshot(path: str, out_path: str, *, engine: str = "device",
                    csr: bool = True, method: str = "staged", rho: int = 4,
                    compress: Optional[str] = None,
                    compress_level: Optional[int] = None,
                    device=None) -> GraphMeta:
    """Convert an MTX file to a ``.gvel`` snapshot of the resolved graph
    (reverse edges materialized, a pattern field unweighted), with a
    prebuilt CSR unless ``csr=False``; the same as
    ``open_graph(path).save(out_path, ...)``.  Returns the header's
    :class:`GraphMeta`."""
    from .source import open_graph

    src = open_graph(path, engine=engine, device=device)
    if src.format != "mtx":
        raise ValueError(f"{path}: missing MatrixMarket banner")
    src.save(out_path, csr=csr, method=method, rho=rho, compress=compress,
             compress_level=compress_level)
    return src._mtx_header().meta


def write_mtx(path: str, src, dst, weights=None, *, num_vertices: int,
              symmetric: bool = False) -> None:
    """Write 0-based edges (tensors or arrays) as a 1-based MTX file; the
    text is the reference's for the same arrays."""
    src, dst, weights = _np(src), _np(dst), _np(weights)
    field = "pattern" if weights is None else "real"
    sym = "symmetric" if symmetric else "general"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {sym}\n")
        f.write("% generated by repro.core.mtx\n")
        f.write(f"{num_vertices} {num_vertices} {len(src)}\n")
        if weights is None:
            for u, v in zip(src, dst):
                f.write(f"{u + 1} {v + 1}\n")
        else:
            for u, v, w in zip(src, dst, np.asarray(weights)):
                f.write(f"{u + 1} {v + 1} {w}\n")
