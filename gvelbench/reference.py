"""The plain reference and the comparison that decides ``correct``.

Plain NumPy over the arrays the benchmark generated (``graphs.make``),
never over anything the program made.  The CSR is the edges grouped by
source, each row's targets (and weights) in file order: the stable
argsort of ``chip_smoke.py::csr_oracle``, computed here as a sort of the
unique keys ``src << 32 | position``.

Every comparison counts the entries that differ; each count has the
limit 0.  A product of another length counts every entry past the
shorter one as differing.

The controls break one guarantee that every configuration states, in the
reference put in the program's place: a CSR whose rows hold their targets
in reverse file order (what an unstable sort gives), and an edge list
grouped by source instead of in file order.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def stable_order(src: np.ndarray) -> np.ndarray:
    """Positions of ``src`` sorted by value, ties in file order."""
    pos = np.arange(len(src), dtype=np.int64)
    keys = (src.astype(np.int64) << 32) | pos
    keys.sort()
    return keys & 0xFFFFFFFF


def vertex_count(src: np.ndarray, dst: np.ndarray) -> int:
    """The loader's vertex count of a text file: largest id + 1."""
    if not len(src):
        return 0
    return int(max(src.max(), dst.max())) + 1


def csr(src, dst, weights, num_vertices: int, order=None) -> Dict:
    """``{"offsets" (int64, V+1), "targets", "weights" or None}``."""
    if order is None:
        order = stable_order(src)
    offsets = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=num_vertices), out=offsets[1:])
    return {"offsets": offsets, "targets": dst[order],
            "weights": None if weights is None else weights[order],
            "num_vertices": num_vertices}


def differing(got: Optional[np.ndarray], want: Optional[np.ndarray]) -> int:
    """Entries of ``got`` unequal to ``want``'s, and the length gap."""
    if got is None and want is None:
        return 0
    if got is None or want is None:
        return len(want if got is None else got)
    n = min(len(got), len(want))
    return int(np.count_nonzero(got[:n] != want[:n])) + abs(len(got) -
                                                            len(want))


def compare_csr(got: Dict, want: Dict, weighted: bool,
                num_vertices: int) -> Dict[str, int]:
    """``got``: ``offsets``, ``targets``, ``weights``, ``num_vertices``."""
    out = {"vertices_off": abs(int(got["num_vertices"]) - num_vertices),
           "offsets_wrong": differing(got["offsets"].astype(np.int64),
                                      want["offsets"]),
           "targets_wrong": differing(got["targets"], want["targets"])}
    if weighted:
        out["weights_wrong"] = differing(got["weights"], want["weights"])
    return out


def compare_edges(got: Dict, src, dst, weights,
                  num_vertices: int) -> Dict[str, int]:
    """``got``: ``src``, ``dst``, ``weights``, ``num_vertices``."""
    out = {"vertices_off": abs(int(got["num_vertices"]) - num_vertices),
           "edges_off": abs(len(got["src"]) - len(src)),
           "src_wrong": differing(got["src"], src),
           "dst_wrong": differing(got["dst"], dst)}
    if weights is not None:
        out["weights_wrong"] = differing(got["weights"], weights)
    return out


def worst(counts) -> Dict[str, int]:
    """The largest of each count over several comparisons."""
    out: Dict[str, int] = {}
    for c in counts:
        for k, v in c.items():
            out[k] = max(out.get(k, 0), int(v))
    return out


# ---------------------------------------------------------------------------
# controls: the reference with one guarantee broken
# ---------------------------------------------------------------------------

def control_csr(src, dst, weights, num_vertices: int) -> Dict:
    """Rows in reverse file order: sort by (source, -position)."""
    pos = np.arange(len(src), dtype=np.int64)
    keys = (src.astype(np.int64) << 32) | (len(src) - 1 - pos)
    keys.sort()
    order = len(src) - 1 - (keys & 0xFFFFFFFF)
    return csr(src, dst, weights, num_vertices, order=order)


def control_edges(src, dst, weights) -> Dict:
    """Edges grouped by source, in file order within a source."""
    order = stable_order(src)
    return {"src": src[order], "dst": dst[order],
            "weights": None if weights is None else weights[order],
            "num_vertices": vertex_count(src, dst)}
