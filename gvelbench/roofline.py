"""Peaks and the least bytes each layer must move.

A roofline share is the least time the card could take for the work,
over the time it took.  The least time counts the work, not the kernel's
slots: each input byte read once and each output byte written once,
whatever implements it.  These layers do no arithmetic worth counting, so
the bound is memory bandwidth, or for the exchange between cards the
links' bandwidth.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
# the same data sheet: NVLink at 900 GB/s a card, 450 GB/s each way
LINK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 450e9}


def _peak(table, what: str, kind: str) -> float:
    try:
        return table[kind]
    except KeyError:
        raise ValueError(f"no published {what} for {kind!r}; "
                         f"known: {sorted(table)}") from None


def peak_bytes_per_s(kind: str) -> float:
    return _peak(PEAK_BYTES_PER_S, "memory bandwidth", kind)


def link_bytes_per_s(kind: str) -> float:
    """One direction of one card's links."""
    return _peak(LINK_BYTES_PER_S, "link bandwidth", kind)


def parse_bytes(file_bytes: int, edges: int, weighted: bool) -> int:
    """The text read once; each edge's two int32 ids (and its float32
    weight) written once."""
    return file_bytes + edges * (8 + (4 if weighted else 0))


def build_bytes(edges: int, num_vertices: int, weighted: bool) -> int:
    """Each edge's ids read once and its target written once (12 B), its
    weight read and written (8 B), and the int64 offsets written."""
    return edges * (12 + (8 if weighted else 0)) + (num_vertices + 1) * 8


def exchange_bytes(moves: np.ndarray, weighted: bool = False) -> int:
    """The bytes the busiest card must send or receive in the exchange:
    ``moves[i, j]`` edges go from the card that parsed them (``i``) to the
    card that owns their source (``j``), each as two int32 ids (and a
    float32 weight); edges that stay on their card move nothing."""
    off = np.asarray(moves, np.int64).copy()
    np.fill_diagonal(off, 0)
    busiest = max(int(off.sum(1).max()), int(off.sum(0).max()))
    return busiest * (8 + (4 if weighted else 0))
