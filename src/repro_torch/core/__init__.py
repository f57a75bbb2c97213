"""GVEL core in PyTorch: graph files -> edge lists and CSRs on a Hopper card.

Public API:
    open_graph -> GraphSource            -- the front door (text, MTX or
                                            .gvel; raw, gzip or framed):
                                            .info() / .edgelist() / .csr()
                                            / .csr(rows=) / .neighbors() /
                                            .degree() / .stream() / .save()
    SourceCache, query, default_cache    -- the hot-graph cache and the
                                            serving entry (query(path,
                                            "neighbors", vertex=v))
    slice_csr                            -- rows [lo, hi) as a row-local CSR
    load_edgelist, load_csr, read_csr    -- thin wrappers over a GraphSource
    load_csr_sharded_stream,
    load_csr_sharded, host_shard_and_load-- the sharded load over a
                                            torch DeviceMesh, one process
                                            per rank (GraphSource.
                                            csr_sharded(mesh) is its front
                                            door)
    tune                                 -- measured block geometry
                                            (open_graph(tune=True))
    convert_to_csr, symmetrize           -- in-memory EdgeList transforms
    read_edgelist, read_edgelist_numpy   -- the streaming engine's wrapper
                                            and the numpy host engine
                                            (engines "numpy", "threads")
    baselines, parse_np                  -- the paper's baseline loaders;
                                            the host engines' numpy parse
    save_snapshot, read_snapshot,
    Snapshot                             -- the .gvel container
    read_mtx, read_mtx_csr, write_mtx,
    mtx_to_snapshot                      -- MatrixMarket files
    register_codec, get_codec, available_codecs,
    write_framed, compress_file_framed   -- codecs and framed containers
    make_graph_file, rmat_edges, ...     -- synthetic graphs (numpy)
    FaultPlan, FaultSpec, fault_plan, ...-- fault injection and recovery
    LoadOptions, SourceInfo, LoaderEngine-- option / metadata / engine types
    EdgeList, CSR, GraphMeta             -- core types (tensors; .numpy(),
                                            from_numpy)
    env                                  -- device resolution, fingerprint
"""
from .types import CSR, EdgeList, GraphMeta
from .loader import (LoaderEngine, LoadOptions, available_engines,
                     get_engine, load_csr, load_edgelist, register_engine)
from .source import GraphSource, SourceInfo, open_graph, slice_csr
from .cache import SourceCache, default_cache, query
from .edgelist import read_edgelist, read_edgelist_numpy, symmetrize
from .csr import convert_to_csr, csr_to_dense, read_csr
from .mtx import mtx_to_snapshot, read_mtx, read_mtx_csr, write_mtx
from .snapshot import Snapshot, SnapshotError, read_snapshot, save_snapshot
from .codecs import (available_codecs, compress_file_framed, get_codec,
                     register_codec, write_framed)
from .generate import (grid_edges, make_graph_file, rmat_edges,
                       uniform_edges, write_edgelist)
from .distributed import (host_shard_and_load, load_csr_sharded,
                          load_csr_sharded_stream)
from .faults import (CorruptGraphError, FaultPlan, FaultSpec, ShardLoadError,
                     StageTimeout, fault_plan, plan_from_env, set_fault_plan)
from . import (baselines, blocks, build, cache, codecs, csr, degrees,
               distributed, edgelist, env, faults, generate, indexing, loader,
               mtx, parse, parse_np, snapshot, source, tune)

__all__ = [
    "CSR", "EdgeList", "GraphMeta",
    "open_graph", "GraphSource", "SourceInfo", "LoadOptions", "slice_csr",
    "SourceCache", "query", "default_cache",
    "load_edgelist", "load_csr", "register_engine", "get_engine",
    "available_engines", "LoaderEngine",
    "save_snapshot", "read_snapshot", "Snapshot", "SnapshotError",
    "register_codec", "get_codec", "available_codecs",
    "compress_file_framed", "write_framed",
    "read_edgelist", "read_edgelist_numpy", "symmetrize",
    "convert_to_csr", "read_csr", "csr_to_dense",
    "read_mtx", "read_mtx_csr", "write_mtx", "mtx_to_snapshot",
    "make_graph_file", "rmat_edges", "uniform_edges", "grid_edges",
    "write_edgelist",
    "load_csr_sharded", "load_csr_sharded_stream", "host_shard_and_load",
    "FaultPlan", "FaultSpec", "StageTimeout", "ShardLoadError",
    "CorruptGraphError", "set_fault_plan", "fault_plan", "plan_from_env",
    "baselines", "blocks", "build", "cache", "codecs", "csr", "degrees",
    "distributed", "edgelist", "env", "faults", "generate", "indexing",
    "loader", "mtx", "parse", "parse_np", "snapshot", "source", "tune",
]
