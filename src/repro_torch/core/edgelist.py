"""Edge-list transforms on the device: the port's ``symmetrize``.

The port of ``repro/core/edgelist.py::symmetrize`` (the reference's host
parsers are not ported: the port parses on the card, in the loader).
"""
from __future__ import annotations

import torch

from .types import EdgeList


def symmetrize(el: EdgeList) -> EdgeList:
    """Append every edge's reverse, after all the forward edges, on the edge
    list's device (symmetric graphs store each edge once; self-loops are
    doubled, as in the reference)."""
    n = int(el.num_edges)
    src, dst = el.src[:n], el.dst[:n]
    w = None if el.weights is None else el.weights[:n].repeat(2)
    return EdgeList(torch.cat([src, dst]), torch.cat([dst, src]), w, 2 * n,
                    el.num_vertices)
