"""The port's public surface held against the JAX package's on the CPU:
the ``CSR`` row accessors, every name of ``repro.core.__all__`` (but the
jax shim), ``tune=`` at every entry point, the small pieces ported with
them (``read_csr``, ``csr_to_dense``, ``LoaderEngine``, ``generate``), the
pinned divergence of ``convert_to_csr`` on an unknown method or engine, and
an import check: the serving modules, the host engines and baselines and
the scripts load neither jax nor the JAX package.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import generate as jgenerate
import repro_torch
import repro_torch.core as core
from repro_torch.core import generate, open_graph

import torch_serving as ts

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# names of repro.core.__all__ the port does not have, and why (ROADMAP.md)
WAITING = {
    "compat": "a jax-only shim",
}


def test_every_reference_name_is_ported_or_waits():
    missing = [n for n in jcore.__all__ if not hasattr(core, n)]
    assert sorted(missing) == sorted(WAITING)
    for name in jcore.__all__:
        if name not in WAITING:
            assert name in core.__all__, name
    assert not [n for n in WAITING if hasattr(core, n)], \
        "a waiting name was ported: drop it from WAITING"


def test_names_keep_their_kind():
    for name in jcore.__all__:
        if name in WAITING:
            continue
        ref, got = getattr(jcore, name), getattr(core, name)
        assert type(ref).__name__ == type(got).__name__, name


# ---- CSR row accessors -------------------------------------------------------

def _products(tmp_path):
    """(port CSR, reference CSR) pairs: text, .gvel raw and zlib, rows."""
    path, v, _ = ts.text_file(tmp_path, "t", weighted=True, tail=3)
    out = [(open_graph(path, weighted=True, num_vertices=v,
                       device="cpu").csr(),
            jcore.open_graph(path, engine="device", weighted=True,
                             num_vertices=v).csr())]
    for compress in (None, "zlib"):
        gv, v, _ = ts.snapshot_file(tmp_path, f"s{compress}", tail=3,
                                    compress=compress, weighted=True)
        got, want = open_graph(gv, device="cpu"), jcore.open_graph(gv)
        out.append((got.csr(), want.csr()))
        out.append((got.csr(rows=(10, 40)), want.csr(rows=(10, 40))))
        out.append((got.csr(rows=(v - 3, v)), want.csr(rows=(v - 3, v))))
    return out


def test_csr_row_accessors_match_reference(tmp_path):
    for got, want in _products(tmp_path):
        degs = got.degrees()
        assert isinstance(degs, torch.Tensor) and degs.device.type == "cpu"
        assert ts.same(degs, want.degrees())
        for u in range(got.num_rows):
            d = got.degree(u)
            assert isinstance(d, torch.Tensor) and d.dim() == 0
            assert int(d) == int(want.degree(u))
            nbrs = got.neighbors(u)
            assert ts.same(nbrs, want.neighbors(u))
            if nbrs.numel():
                assert nbrs.data_ptr() >= got.targets.data_ptr()  # a view


def test_row_local_accessors_take_the_local_row(tmp_path):
    gv, v, oracle = ts.snapshot_file(tmp_path, "r")
    g = open_graph(gv, device="cpu")
    part = g.csr(rows=(20, 30))
    for u in range(20, 30):
        assert ts.same(part.neighbors(u - 20), g.neighbors(u))
        assert int(part.degree(u - 20)) == g.degree(u)


def test_degrees_needs_no_host_sync(tmp_path, monkeypatch):
    path, v, _ = ts.text_file(tmp_path, "d")
    csr = open_graph(path, device="cpu").csr()

    def no_sync(*a, **kw):
        raise AssertionError("degrees() read a value on the host")

    for name in ("tolist", "item", "__int__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    degs = csr.degrees()
    monkeypatch.undo()
    assert degs.shape == (csr.num_rows,)


# ---- options taken at open ---------------------------------------------------

def test_tune_loads_through_every_entry_point(tmp_path, monkeypatch):
    """``tune=True`` at ``open_graph``, ``load_csr`` and ``load_edgelist``:
    the first sweeps once (a stand-in sweep here) and keeps the winner, the
    others read it, and every product equals the untuned one."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    sweeps = []
    monkeypatch.setattr(core.tune, "run_sweep", lambda *a, **k: sweeps.append(
        k) or [{"beta": 2048, "batch_blocks": 2, "seconds": 0.1,
                "mb_per_s": 1.0}])
    path, v, oracle = ts.text_file(tmp_path, "t")
    src = open_graph(path, device="cpu", num_vertices=v, tune=True)
    assert ts.same_csr(src.csr(), oracle)
    assert ts.same_csr(repro_torch.load_csr(path, device="cpu",
                                            num_vertices=v, tune=True),
                       oracle)
    el = core.load_edgelist(path, device="cpu", tune=True)
    plain = core.load_edgelist(path, device="cpu")
    assert ts.same(el.src, plain.src) and ts.same(el.dst, plain.dst)
    assert len(sweeps) == 1


def test_faults_is_accepted_at_open(tmp_path):
    path, v, oracle = ts.text_file(tmp_path, "t")
    plan = core.FaultPlan([core.FaultSpec("block", "latency", index=0)])
    g = open_graph(path, device="cpu", num_vertices=v, faults=plan)
    assert g.options.faults is plan
    assert ts.same_csr(g.csr(), oracle)
    assert plan.injected() == {"block:latency": 1}


# ---- small pieces: read_csr, csr_to_dense, LoaderEngine ----------------------

def test_read_csr_and_dense_match_reference(tmp_path):
    path, v, oracle = ts.text_file(tmp_path, "t", v=20, e=90, weighted=True)
    got = core.read_csr(path, weighted=True, num_vertices=v, device="cpu",
                        engine="jax")
    want = jcore.read_csr(path, weighted=True, num_vertices=v)
    assert ts.same_csr(got, want) and ts.same_csr(got, oracle)
    dense = core.csr_to_dense(got)
    assert dense.dtype == np.int64
    assert np.array_equal(dense, jcore.csr_to_dense(want))
    part = open_graph(path, device="cpu", num_vertices=v).csr(rows=(3, 9))
    assert np.array_equal(core.csr_to_dense(part),
                          jcore.csr_to_dense(jcore.open_graph(
                              path, engine="device",
                              num_vertices=v).csr(rows=(3, 9))))


def test_convert_to_csr_refuses_what_the_reference_takes_another_way():
    """An unknown ``method`` or ``engine``: the port raises ``ValueError``
    (nothing falls back quietly), where the reference builds ``csr_np``
    for any method under ``engine="numpy"`` and takes its jax path for an
    unknown engine.  A pinned divergence, on a 3-edge list."""
    from repro.core.build import csr_np as jcsr_np
    from repro.core.types import EdgeList as JEdgeList
    from repro_torch.core.types import EdgeList
    src = np.array([0, 2, 1], np.int32)
    dst = np.array([1, 0, 2], np.int32)
    el = EdgeList(torch.from_numpy(src), torch.from_numpy(dst), None, 3, 3)
    for kw in ({"method": "bogus"}, {"method": "bogus", "engine": "numpy"}):
        with pytest.raises(ValueError, match="unknown method 'bogus'"):
            core.convert_to_csr(el, **kw)
    with pytest.raises(ValueError,
                       match="unknown convert_to_csr engine 'bogus'"):
        core.convert_to_csr(el, engine="bogus")
    jel = JEdgeList(src, dst, None, np.int32(3), 3)
    want = jcsr_np(src, dst, None, 3)
    got = jcore.convert_to_csr(jel, method="bogus", engine="numpy")
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.targets, want.targets)
    jax_path = jcore.convert_to_csr(jel, engine="jax")
    got = jcore.convert_to_csr(jel, engine="bogus")
    np.testing.assert_array_equal(np.asarray(got.offsets),
                                  np.asarray(jax_path.offsets))
    np.testing.assert_array_equal(np.asarray(got.targets),
                                  np.asarray(jax_path.targets))
    np.testing.assert_array_equal(np.asarray(got.offsets), want.offsets)
    with pytest.raises(ValueError, match="unknown method"):
        jcore.convert_to_csr(jel, method="bogus", engine="bogus")


def test_loader_engine_protocol():
    for name in core.available_engines():
        assert isinstance(core.get_engine(name), core.LoaderEngine)
    assert not isinstance(object(), core.LoaderEngine)


# ---- generate: the reference's edges and bytes -------------------------------

@pytest.mark.parametrize("kind", ["rmat", "uniform", "grid"])
@pytest.mark.parametrize("weighted", [False, True])
def test_make_graph_file_writes_the_reference_bytes(tmp_path, kind,
                                                    weighted):
    a, b = str(tmp_path / "port.el"), str(tmp_path / "ref.el")
    got = generate.make_graph_file(a, kind, scale=7, edge_factor=4,
                                   weighted=weighted, seed=3)
    want = jgenerate.make_graph_file(b, kind, scale=7, edge_factor=4,
                                     weighted=weighted, seed=3)
    assert got == want
    assert open(a, "rb").read() == open(b, "rb").read()


def test_generators_match_reference():
    for got, want in ((generate.rmat_edges(8, 4, seed=1),
                       jgenerate.rmat_edges(8, 4, seed=1)),
                      (generate.uniform_edges(100, 500, 2),
                       jgenerate.uniform_edges(100, 500, 2)),
                      (generate.grid_edges(9), jgenerate.grid_edges(9))):
        assert got[2] == want[2]
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        generate.make_graph_file("x.el", "star")


# ---- import isolation --------------------------------------------------------

def test_port_modules_load_no_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core.cache, "
            "repro_torch.core.faults, repro_torch.core.generate, "
            "repro_torch.core.distributed, repro_torch.core.tune, "
            "repro_torch.core.parse_np, repro_torch.core.baselines, "
            "repro_torch.core.edgelist\n"
            "import repro_torch.scripts.convert, "
            "repro_torch.scripts.chaos_matrix, "
            "repro_torch.scripts.local_world\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("REPRO_FAULTS", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
