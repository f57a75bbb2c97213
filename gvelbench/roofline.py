"""Peaks and the least bytes each layer must move.

A roofline share is the least time the card could take for the work,
over the time it took.  The least time counts the work, not the kernel's
slots: each input byte read once and each output byte written once,
whatever implements it.  These layers do no arithmetic worth counting, so
the bound is memory bandwidth.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 at 3.35 TB/s
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_bytes_per_s(kind: str) -> float:
    try:
        return PEAK_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(f"no published memory bandwidth for {kind!r}; "
                         f"known: {sorted(PEAK_BYTES_PER_S)}") from None


def parse_bytes(file_bytes: int, edges: int, weighted: bool) -> int:
    """The text read once; each edge's two int32 ids (and its float32
    weight) written once."""
    return file_bytes + edges * (8 + (4 if weighted else 0))


def build_bytes(edges: int, num_vertices: int, weighted: bool) -> int:
    """Each edge's ids read once and its target written once (12 B), its
    weight read and written (8 B), and the int64 offsets written."""
    return edges * (12 + (8 if weighted else 0)) + (num_vertices + 1) * 8
