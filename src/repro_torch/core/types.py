"""Core data types of the port: edge lists and CSRs over tensors.

The dtype contract is the reference's (``repro/core/types.py``): int32
vertex ids and targets, float32 weights, ``row_start`` for row-local CSRs.
Offsets from the port's loaders are int64 (cast once from the int32 scan).
``.numpy()`` and ``from_numpy`` carry the JAX package's products, as numpy
arrays, into the port's types and back.  :class:`GraphMeta` is a file
header's view of a graph (MTX banner and size line).  ``to(device)`` moves
a product's tensors (the host engines build on the CPU and move once, at
the end); :func:`csr_from_dense` is the reference's small test helper.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


def _np(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    t = torch.from_numpy(np.array(x))
    return t if device is None else t.to(device)


def _to(x, device) -> Optional[torch.Tensor]:
    return None if x is None else x.to(device)


@dataclasses.dataclass
class EdgeList:
    """COO edges; ``weights`` is None for unweighted graphs."""

    src: Any                      # (E,) int32
    dst: Any                      # (E,) int32
    weights: Optional[Any]        # (E,) float32 or None
    num_edges: int
    num_vertices: int

    def numpy(self) -> "EdgeList":
        return EdgeList(_np(self.src), _np(self.dst), _np(self.weights),
                        int(self.num_edges), int(self.num_vertices))

    @classmethod
    def from_numpy(cls, el, device=None) -> "EdgeList":
        """Any edge list with numpy-convertible ``src``/``dst``/``weights``
        (the reference's included) as tensors on ``device``."""
        return cls(_tensor(el.src, device), _tensor(el.dst, device),
                   _tensor(el.weights, device), int(el.num_edges),
                   int(el.num_vertices))

    def to(self, device) -> "EdgeList":
        """The edge list with its tensors on ``device`` (themselves where
        they already are)."""
        return EdgeList(self.src.to(device), self.dst.to(device),
                        _to(self.weights, device), int(self.num_edges),
                        int(self.num_vertices))


@dataclasses.dataclass
class CSR:
    """Compressed sparse row adjacency: ``offsets[u] .. offsets[u+1]`` index
    ``targets``/``weights`` for vertex ``u``; ``row_start`` is the first
    vertex of a row-local CSR."""

    offsets: Any                  # (V_local + 1,) int64 (or int32)
    targets: Any                  # (E_local,) int32
    weights: Optional[Any]        # (E_local,) float32 or None
    num_vertices: int
    row_start: int = 0

    @property
    def num_rows(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def degree(self, u) -> Any:
        """Row ``u``'s out-degree as a 0-d tensor on the CSR's device (on a
        row-local CSR ``u`` is the local row, ``vertex - row_start``)."""
        return self.offsets[u + 1] - self.offsets[u]

    def neighbors(self, u):
        """Row ``u``'s targets, a view of ``targets`` (local row, as
        :meth:`degree`)."""
        lo, hi = int(self.offsets[u]), int(self.offsets[u + 1])
        return self.targets[lo:hi]

    def degrees(self) -> Any:
        """Every row's out-degree, on the CSR's device, with no host sync."""
        return self.offsets[1:] - self.offsets[:-1]

    def numpy(self) -> "CSR":
        return CSR(_np(self.offsets), _np(self.targets), _np(self.weights),
                   int(self.num_vertices), int(self.row_start))

    @classmethod
    def from_numpy(cls, csr, device=None) -> "CSR":
        """Any CSR with numpy-convertible arrays (the reference's included)
        as tensors on ``device``."""
        return cls(_tensor(csr.offsets, device), _tensor(csr.targets, device),
                   _tensor(csr.weights, device), int(csr.num_vertices),
                   int(getattr(csr, "row_start", 0)))

    def to(self, device) -> "CSR":
        """The CSR with its tensors on ``device`` (themselves where they
        already are)."""
        return CSR(self.offsets.to(device), self.targets.to(device),
                   _to(self.weights, device), int(self.num_vertices),
                   int(self.row_start))


@dataclasses.dataclass(frozen=True)
class GraphMeta:
    """Header information for a graph file."""

    num_vertices: int
    num_edges: int                # as declared (before symmetric expansion)
    weighted: bool
    symmetric: bool
    base: int = 1                 # vertex-id base in the file (MTX is 1-based)
    pattern: bool = False         # MTX 'pattern': no weight column


def csr_from_dense(adj, device=None) -> CSR:
    """A CSR from a dense ``(V, V)`` adjacency count matrix, on ``device``
    (default CUDA): int64 offsets, int32 targets in row-major order, a
    repeated entry once per count (a small-graph test helper)."""
    from .env import resolve_device
    device = resolve_device(device)
    adj = np.asarray(adj)
    v = adj.shape[0]
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(adj.sum(axis=1).astype(np.int64), out=offsets[1:])
    targets = np.concatenate([np.repeat(np.arange(v), adj[u])
                              for u in range(v)]) if v else np.zeros(0)
    return CSR(torch.from_numpy(offsets),
               torch.from_numpy(targets.astype(np.int32)), None,
               v).to(device)
