"""A configuration that states ``"symmetric": true``: the reference's edges
as the product holds them, against a layout written by hand and against
the port's own symmetric load on the CPU; and the sharded cell that the
port cannot load symmetric, refused before any graph is made."""
import copy
import time

import numpy as np
import pytest

from gvelbench import graphs, harness, reference
from gvelbench.tests import spare

SMALL = {"scale": 9}


def test_product_edges_by_hand():
    # a self-loop (2, 2) and a duplicate (0, 1) twice
    g = graphs.Graph(np.array([0, 2, 0], np.int32),
                     np.array([1, 2, 1], np.int32),
                     np.array([5, 6, 7], np.float32))
    src, dst, w = reference.product_edges(g, {})
    assert src is g.src and dst is g.dst and w is g.weights
    src, dst, w = reference.product_edges(g, {"symmetric": True})
    assert src.tolist() == [0, 2, 0, 1, 2, 1]
    assert dst.tolist() == [1, 2, 1, 0, 2, 0]
    assert w.tolist() == [5, 6, 7, 5, 6, 7]
    ref = reference.csr(src, dst, w, reference.vertex_count(src, dst))
    # rows in the order of the product's edges: row 2 holds the loop twice
    assert ref["offsets"].tolist() == [0, 2, 4, 6]
    assert ref["targets"].tolist() == [1, 1, 0, 0, 2, 2]
    assert ref["weights"].tolist() == [5, 7, 5, 7, 6, 6]
    unweighted = graphs.Graph(g.src, g.dst, None)
    assert reference.product_edges(unweighted, {"symmetric": True})[2] \
        is None
    assert not reference.symmetric({"symmetric": False})


def configs():
    """The spare symmetric GAP file, and Graph500's text loaded symmetric
    (hubs, self-loops and duplicates)."""
    b = spare.bench()
    gap = harness.cell_parts(b, "gap-urand-s22-wsym.csr")[1]
    g500 = harness.cell_parts(b, "graph500-s22.csr")[1]
    return [dict(gap, **SMALL), dict(g500, symmetric=True, **SMALL)]


@pytest.mark.parametrize("cfg", configs(), ids=lambda c: c["name"])
@pytest.mark.parametrize("product", ["csr", "edgelist"])
def test_the_reference_is_the_ports_symmetric_load(tmp_path, cfg, product):
    rt = harness.import_program()
    path = str(tmp_path / "graph.el")
    g = graphs.make(cfg, 2**31 + 5, path)
    weighted = g.weights is not None
    src, dst, w = reference.product_edges(g, cfg)
    assert len(src) == 2 * g.num_edges
    v = reference.vertex_count(src, dst)
    h = rt.open_graph(path, weighted=weighted, symmetric=True, device="cpu")
    if product == "csr":
        out = h.csr(method="staged")
        n = int(out.offsets[-1])
        got = {"offsets": out.offsets.numpy(),
               "targets": out.targets[:n].numpy(),
               "weights": None if out.weights is None
               else out.weights[:n].numpy(),
               "num_vertices": out.num_vertices}
        c = reference.compare_csr(got, reference.csr(src, dst, w, v),
                                  weighted, v)
    else:
        out = h.edgelist()
        got = {"src": out.src.numpy(), "dst": out.dst.numpy(),
               "weights": None if out.weights is None
               else out.weights.numpy(),
               "num_vertices": out.num_vertices}
        c = reference.compare_edges(got, src, dst, w, v)
    assert all(x == 0 for x in c.values()), c


def test_a_symmetric_sharded_cell_is_refused(monkeypatch):
    b = copy.deepcopy(spare.bench())
    b["workloads"].append({"name": "gap-urand-s22-wsym-d4.csr-sharded",
                           "config": "gap-urand-s22-wsym",
                           "traffic": "csr-sharded", "chips": 4})
    monkeypatch.setattr(harness, "benchmark", lambda root=None: b)

    def never(*args, **kw):
        raise AssertionError("made before the refusal")
    monkeypatch.setattr(harness.graphs, "make", never)
    monkeypatch.setattr(harness.tempfile, "mkdtemp", never)
    with pytest.raises(harness.BenchError, match="symmetric=True"):
        harness.run("gap-urand-s22-wsym-d4.csr-sharded", 7, 0.2, False,
                    t0=time.monotonic(), device="cpu",
                    cfg_override={"scale": 10}, say=lambda m: None)
