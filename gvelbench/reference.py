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
in reverse file order (what an unstable sort gives), an edge list grouped
by source instead of in file order, and a sharded CSR whose first two
ranks hold each other's rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional

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


def shard_rows(want: Dict, d: int) -> List[Dict]:
    """The reference CSR ``want`` cut into ``d`` ranks' rows as the sharded
    load lays them out: rank k holds rows ``[k * rows, (k + 1) * rows)``,
    ``rows = ceil(V / d)``, with ``rows + 1`` offsets from 0 (rows past V
    empty) and its edges' targets (and weights)."""
    v = want["num_vertices"]
    rows = max(-(-v // d), 1)
    out = []
    for k in range(d):
        lo, hi = min(k * rows, v), min((k + 1) * rows, v)
        e_lo, e_hi = int(want["offsets"][lo]), int(want["offsets"][hi])
        offsets = np.full(rows + 1, e_hi - e_lo, np.int64)
        offsets[:hi - lo + 1] = want["offsets"][lo:hi + 1] - e_lo
        out.append({"offsets": offsets,
                    "targets": want["targets"][e_lo:e_hi],
                    "weights": None if want["weights"] is None
                    else want["weights"][e_lo:e_hi],
                    "num_vertices": v, "row_start": k * rows})
    return out


def compare_shards(got: List[Dict], want: List[Dict],
                   weighted: bool) -> Dict[str, int]:
    """Each rank's rows (``offsets``, ``targets``, ``weights``,
    ``num_vertices``, ``row_start``) against :func:`shard_rows`, the counts
    summed over the ranks.  Rows that start elsewhere than the rank's
    range have every offset wrong."""
    out: Dict[str, int] = {}
    for g, w in zip(got, want):
        c = compare_csr(g, w, weighted, w["num_vertices"])
        if int(g["row_start"]) != w["row_start"]:
            c["offsets_wrong"] = max(len(g["offsets"]), len(w["offsets"]))
        for key, v in c.items():
            out[key] = out.get(key, 0) + v
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


def control_shards(src, dst, weights, num_vertices: int, d: int
                   ) -> List[Dict]:
    """The ranks' rows with ranks 0's and 1's swapped."""
    rows = shard_rows(csr(src, dst, weights, num_vertices), d)
    rows[0], rows[1] = rows[1], rows[0]
    return rows


def control_edges(src, dst, weights) -> Dict:
    """Edges grouped by source, in file order within a source."""
    order = stable_order(src)
    return {"src": src[order], "dst": dst[order],
            "weights": None if weights is None else weights[order],
            "num_vertices": vertex_count(src, dst)}
