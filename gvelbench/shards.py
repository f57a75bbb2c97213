"""The file's split among ranks, reckoned by the benchmark itself from the
file's length, the configuration's geometry and the generated arrays.

The file is cut into ``ceil(bytes / beta)`` blocks of ``beta`` bytes, and
rank ``k`` of ``d`` streams blocks ``[k * nb // d, (k + 1) * nb // d)``,
``batch_blocks`` to a launch of the fused parse.  A line belongs to the
block that holds its newline, and so to that block's rank.  The owner of
an edge is the rank whose rows hold its source: ``rows = ceil(V / d)``
rows each.  That is the split of the port's sharded load
(``core/blocks.py``, ``core/distributed.py``), frozen here so that the
benchmark's expectations do not move with the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from . import graphs


def span_blocks(file_bytes: int, cfg: Dict, d: int) -> List[Tuple[int, int]]:
    """``[(block_lo, block_hi)]`` of each rank's span."""
    nb = max(1, -(-file_bytes // cfg["geometry"]["beta"]))
    return [(k * nb // d, (k + 1) * nb // d) for k in range(d)]


def parse_batches(file_bytes: int, cfg: Dict, d: int = 1) -> List[int]:
    """Launches of the fused parse that each rank makes in a load."""
    per = cfg["geometry"]["batch_blocks"]
    return [-(-(hi - lo) // per) for lo, hi in span_blocks(file_bytes, cfg, d)]


def holders(graph: graphs.Graph, cfg: Dict, file_bytes: int,
            d: int) -> np.ndarray:
    """The rank that parses each edge: the one whose span holds the block
    of the edge's newline."""
    newline = np.cumsum(graphs.line_lengths(graph, cfg)) - 1
    block = newline // cfg["geometry"]["beta"]
    lows = np.array([lo for lo, _ in span_blocks(file_bytes, cfg, d)])
    return np.searchsorted(lows, block, side="right") - 1


def moves(graph: graphs.Graph, cfg: Dict, file_bytes: int, d: int,
          num_vertices: int) -> np.ndarray:
    """``(d, d)`` edge counts from the rank that parses them (rows) to the
    rank that owns their source (columns)."""
    rows = max(-(-num_vertices // d), 1)
    owner = graph.src.astype(np.int64) // rows
    held = holders(graph, cfg, file_bytes, d)
    return np.bincount(held * d + owner, minlength=d * d).reshape(d, d)
