"""GVEL core in PyTorch: graph files -> edge lists and CSRs on a Hopper card.

Public API:
    open_graph -> GraphSource            -- the front door (text, MTX or
                                            .gvel; raw, gzip or framed):
                                            .info() / .edgelist() / .csr()
                                            / .csr(rows=) / .neighbors() /
                                            .degree() / .stream() / .save()
    slice_csr                            -- rows [lo, hi) as a row-local CSR
    load_edgelist, load_csr              -- thin wrappers over a GraphSource
    convert_to_csr                       -- in-memory EdgeList -> CSR
    save_snapshot, read_snapshot         -- the .gvel container
    read_mtx, write_mtx                  -- MatrixMarket files
    LoadOptions, SourceInfo              -- option / metadata types
    EdgeList, CSR                        -- core types (tensors; .numpy(),
                                            from_numpy)
    env                                  -- device resolution, fingerprint
"""
from .types import CSR, EdgeList
from .loader import (LoadOptions, available_engines, get_engine, load_csr,
                     load_edgelist, register_engine)
from .source import GraphSource, SourceInfo, open_graph, slice_csr
from .csr import convert_to_csr
from .mtx import read_mtx, write_mtx
from .snapshot import SnapshotError, read_snapshot, save_snapshot
from . import (blocks, build, codecs, csr, degrees, edgelist, env, faults,
               indexing, loader, mtx, parse, snapshot, source)

__all__ = [
    "CSR", "EdgeList", "LoadOptions", "GraphSource", "SourceInfo",
    "open_graph", "slice_csr", "load_csr", "load_edgelist", "register_engine",
    "get_engine", "available_engines", "convert_to_csr", "read_mtx",
    "write_mtx", "SnapshotError", "read_snapshot", "save_snapshot",
    "blocks", "build", "codecs", "csr", "degrees", "edgelist", "env",
    "faults", "indexing", "loader", "mtx", "parse", "snapshot", "source",
]
