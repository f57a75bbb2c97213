"""GVEL core in PyTorch: text edgelist -> CSR on an NVIDIA Hopper card.

Public API:
    open_graph -> GraphSource            -- the front door (text, raw or
                                            gzip): .info() / .edgelist() /
                                            .csr() / .csr(rows=) /
                                            .neighbors() / .degree() /
                                            .stream()
    slice_csr                            -- rows [lo, hi) as a row-local CSR
    load_edgelist, load_csr              -- thin wrappers over a GraphSource
    LoadOptions, SourceInfo              -- option / metadata types
    EdgeList, CSR                        -- core types (tensors; .numpy(),
                                            from_numpy)
    env                                  -- device resolution, fingerprint
"""
from .types import CSR, EdgeList
from .loader import (LoadOptions, available_engines, get_engine, load_csr,
                     load_edgelist, register_engine)
from .source import GraphSource, SourceInfo, open_graph, slice_csr
from . import (blocks, build, codecs, degrees, env, faults, indexing, loader,
               parse, source)

__all__ = [
    "CSR", "EdgeList", "LoadOptions", "GraphSource", "SourceInfo",
    "open_graph", "slice_csr", "load_csr", "load_edgelist", "register_engine",
    "get_engine", "available_engines",
    "blocks", "build", "codecs", "degrees", "env", "faults", "indexing",
    "loader", "parse", "source",
]
