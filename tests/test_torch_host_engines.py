"""The port's host engines and host CSR builds held against the JAX
package's on the CPU, at tolerance 0.

``parse_np`` on awkward bytes; ``read_edgelist_numpy`` and
``read_edgelist_threads`` over worker and chunk counts, weights, bases,
``symmetric``, an ``offset`` and raw, gzip and framed zlib inputs;
``csr_np``, ``csr_staged_np`` and ``csr_binned_np`` over ``num_workers``,
``rho`` and ``bin_bits`` with isolated vertices and a trailing empty row;
``convert_to_csr(engine="numpy")``; the front door with ``engine="numpy"``,
``"threads"`` and ``"pallas"`` against the reference's same engine, and the
CSR also against the port's ``device`` engine; the device rule (no
``device="cpu"``, no CUDA: every new entry point raises, and no default
path reaches a host engine); ``csr_from_dense``.
"""
import gzip

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import build as jbuild
from repro.core import edgelist as jedgelist
from repro.core import parse_np as jparse_np
from repro.core import types as jtypes
from repro.core.cache import SourceCache as JCache
import repro_torch.core as core
from repro_torch.core import build, edgelist, parse_np, types
from repro_torch.core.cache import SourceCache

import torch_serving as ts

CPU = {"device": "cpu"}


def awkward_text(seed, lines=300, *, base=1, v=40, crlf=True, final_nl=True):
    """Edge lines with space or tab separators, CRLF endings, comment lines,
    negative and decimal weights and lines with no weight."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(lines):
        k = rng.integers(0, 12)
        if k == 0:
            out.append(b"# comment 1 2 3")
            continue
        if k == 1:
            out.append(b"% another 4 5")
            continue
        u, x = rng.integers(base, v + base, 2)
        sep = b"\t" if rng.random() < 0.3 else b" "
        line = b"%d%s%d" % (u, sep, x)
        r = rng.random()
        if r < 0.35:
            line += b" %.3f" % (rng.random() * 20 - 10)
        elif r < 0.6:
            line += b" -%d" % rng.integers(0, 99)
        elif r < 0.8:
            line += b" %d.%d" % (rng.integers(0, 9), rng.integers(0, 9999))
        if crlf and rng.random() < 0.3:
            line += b"\r"
        out.append(line)
    text = b"\n".join(out)
    return text + b"\n" if final_nl else text


PARSE_CASES = {
    "awkward": awkward_text(1),
    "awkward_no_final_newline": awkward_text(2, final_nl=False),
    "empty": b"",
    "one_line": b"3 4 2.5\n",
    "one_line_no_newline": b"3 4 -2.5",
    "comments_only": b"# 1 2\n% 3 4\n",
    "missing_weight": b"1 2\n3 4 7\n5 6\n",
    "crlf_tabs": b"1\t2\t0.5\r\n3\t4\r\n\r\n5 6 -1.25\r\n",
    "blank_and_junk": b"\n\n1 2 x\n7 8 9\n1 2 3 4\n",
}


def _same_parse(a, b):
    assert len(a) == len(b) == 4
    for x, y in zip(a[:3], b[:3]):
        if y is None:
            assert x is None
            continue
        assert x.dtype == y.dtype and ts.same(x, y)
    assert a[3] == b[3]


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("base", [0, 1])
def test_parse_chunk_np_matches_reference(case, weighted, base):
    d = np.frombuffer(PARSE_CASES[case], np.uint8)
    _same_parse(parse_np.parse_chunk_np(d, weighted=weighted, base=base),
                jparse_np.parse_chunk_np(d, weighted=weighted, base=base))


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_chunk_bounds_match_reference(case):
    raw = PARSE_CASES[case]
    lines = raw.count(b"\n") + 1
    for data in (raw, np.frombuffer(raw, np.uint8)):
        for k in (1, 3, lines + 5):
            got = parse_np.chunk_bounds(data, k)
            assert got == jparse_np.chunk_bounds(data, k)
            # every cut but the end follows a newline, and the chunks tile
            assert [lo for lo, _ in got[1:]] == [hi for _, hi in got[:-1]]
            for lo, _ in got[1:]:
                assert raw[lo - 1:lo] == b"\n"
            parts = [parse_np.parse_chunk_np(np.frombuffer(raw[lo:hi],
                                                           np.uint8),
                                             weighted=True)
                     for lo, hi in got]
            whole = jparse_np.parse_chunk_np(np.frombuffer(raw, np.uint8),
                                             weighted=True)
            if parts:
                assert ts.same(np.concatenate([p[0] for p in parts]),
                               whole[0])
                assert ts.same(np.concatenate([p[2] for p in parts]),
                               whole[2])


# ---- the host engines ----------------------------------------------------------

HEADER = b"%%MatrixMarket-like header\n% 9 9 9\n"


def _write(tmp_path, name, raw, codec):
    path = tmp_path / name
    if codec == "raw":
        path.write_bytes(raw)
    elif codec == "gzip":
        path = tmp_path / (name + ".gz")
        path.write_bytes(gzip.compress(raw, 1))
    else:
        path = tmp_path / (name + ".elz")
        core.write_framed(str(path), raw, frame_beta=512)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``(codec, base, offset) -> path``: awkward text of 2,000 lines, with
    a header before the body when ``offset``."""
    tmp = tmp_path_factory.mktemp("host_engines")
    out = {}
    for base in (0, 1):
        body = awkward_text(10 + base, 2000, base=base, v=300)
        for codec in ("raw", "gzip", "framed"):
            out[codec, base, False] = _write(tmp, f"b{base}.el", body, codec)
        out["raw", base, True] = _write(tmp, f"h{base}.el", HEADER + body,
                                        "raw")
    return out


def _same_el(got, want):
    assert got.src.device.type == "cpu"
    assert got.src.dtype == torch.int32 and got.dst.dtype == torch.int32
    assert int(got.num_edges) == int(want.num_edges)
    assert int(got.num_vertices) == int(want.num_vertices)
    assert ts.same(got.src, want.src) and ts.same(got.dst, want.dst)
    assert ts.same(got.weights, want.weights)
    if got.weights is not None:
        assert got.weights.dtype == torch.float32


@pytest.mark.parametrize("codec", ["raw", "gzip", "framed"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("base", [0, 1])
def test_read_edgelist_numpy_matches_reference(files, codec, weighted, base):
    p = files[codec, base, False]
    for kw in ({}, {"chunk_bytes": 997}, {"num_chunks": 7},
               {"symmetric": True, "num_vertices": 400}):
        _same_el(edgelist.read_edgelist_numpy(p, weighted=weighted,
                                              base=base, **kw, **CPU),
                 jedgelist.read_edgelist_numpy(p, weighted=weighted,
                                               base=base, **kw))


@pytest.mark.parametrize("num_workers", [1, 3, 8])
@pytest.mark.parametrize("chunks_per_worker", [1, 4])
@pytest.mark.parametrize("codec", ["raw", "gzip", "framed"])
def test_read_edgelist_threads_matches_reference(files, num_workers,
                                                 chunks_per_worker, codec):
    for base in (0, 1):
        p = files[codec, base, False]
        for weighted, symmetric in ((False, False), (True, False),
                                    (True, True)):
            kw = dict(weighted=weighted, base=base, symmetric=symmetric,
                      num_workers=num_workers,
                      chunks_per_worker=chunks_per_worker)
            _same_el(edgelist.read_edgelist_threads(p, **kw, **CPU),
                     jedgelist.read_edgelist_threads(p, **kw))


@pytest.mark.parametrize("engine", ["numpy", "threads"])
def test_host_engines_take_an_offset(files, engine):
    for base in (0, 1):
        p = files["raw", base, True]
        got = core.load_edgelist(p, engine=engine, weighted=True, base=base,
                                 offset=len(HEADER), **CPU)
        want = jcore.load_edgelist(p, engine=engine, weighted=True,
                                   base=base, offset=len(HEADER))
        _same_el(got, want)
        _same_el(got, jcore.load_edgelist(files["raw", base, False],
                                          engine=engine, weighted=True,
                                          base=base))


def test_host_engine_on_cpu_returns_its_own_arrays(files):
    el = edgelist.read_edgelist_numpy(files["raw", 1, False], **CPU)
    again = el.to("cpu")
    assert again.src.data_ptr() == el.src.data_ptr()


# ---- the host CSR builds --------------------------------------------------------

def _edges(seed, weighted, v=90, e=3000):
    """Skewed sources over [0, v - 7) (isolated vertices and a trailing
    empty row), with self-loops and repeats."""
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, e) % (v - 7)).astype(np.int32)
    src[rng.integers(0, e, 40)] = 3
    dst = rng.integers(0, v, e).astype(np.int32)
    w = (rng.random(e) * 9 - 3).astype(np.float32) if weighted else None
    return src, dst, w, v


def _same_host_csr(got, want):
    assert got.offsets.dtype == torch.int64 and got.targets.dtype == torch.int32
    assert got.offsets.device.type == "cpu"
    assert ts.same_csr(got, want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("num_workers", [1, 4])
def test_csr_staged_np_matches_reference(weighted, num_workers):
    src, dst, w, v = _edges(1, weighted)
    for rho in (1, 3, 4, 8):
        _same_host_csr(build.csr_staged_np(src, dst, w, v, rho=rho,
                                           num_workers=num_workers),
                       jbuild.csr_staged_np(src, dst, w, v, rho=rho,
                                            num_workers=num_workers))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("num_workers", [1, 4])
def test_csr_binned_np_matches_reference(weighted, num_workers):
    src, dst, w, v = _edges(2, weighted)
    padded_src = np.concatenate([src, np.full(5, -1, np.int32)])
    padded_dst = np.concatenate([dst, np.zeros(5, np.int32)])
    padded_w = None if w is None else np.concatenate([w, np.ones(5, np.float32)])
    for bin_bits in (None, 1, 3, 20):
        for s, d, ww in ((src, dst, w), (padded_src, padded_dst, padded_w)):
            _same_host_csr(build.csr_binned_np(s, d, ww, v, bin_bits=bin_bits,
                                               num_workers=num_workers),
                           jbuild.csr_binned_np(s, d, ww, v,
                                                bin_bits=bin_bits,
                                                num_workers=num_workers))


@pytest.mark.parametrize("weighted", [False, True])
def test_host_builds_of_no_edges_match_reference(weighted):
    e = np.zeros(0, np.int32)
    w = np.zeros(0, np.float32) if weighted else None
    _same_host_csr(build.csr_staged_np(e, e, w, 5),
                   jbuild.csr_staged_np(e, e, w, 5))
    _same_host_csr(build.csr_binned_np(e, e, w, 5),
                   jbuild.csr_binned_np(e, e, w, 5))
    assert ts.same_csr(build.csr_np(e, e, w, 5), jbuild.csr_np(e, e, w, 5))


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_np_matches_reference(weighted):
    src, dst, w, v = _edges(3, weighted)
    got, want = build.csr_np(src, dst, w, v), jbuild.csr_np(src, dst, w, v)
    assert got.offsets.dtype == np.int64 and ts.same_csr(got, want)


@pytest.mark.parametrize("method", ["global", "staged", "binned"])
@pytest.mark.parametrize("weighted", [False, True])
def test_convert_to_csr_numpy_matches_reference(method, weighted):
    src, dst, w, v = _edges(4, weighted)
    jel = jtypes.EdgeList(src, dst, w, np.int64(len(src)), v)
    el = types.EdgeList.from_numpy(jel, device="cpu")
    for bin_bits in (None, 2):
        got = core.convert_to_csr(el, method=method, bin_bits=bin_bits,
                                  engine="numpy")
        _same_host_csr(got, jcore.convert_to_csr(
            jel, method=method, bin_bits=bin_bits, engine="numpy"))
        dev = core.convert_to_csr(el, method=method, bin_bits=bin_bits)
        assert ts.same(got.offsets, dev.offsets)
        assert ts.same(got.targets, dev.targets)
        assert ts.same(got.weights, dev.weights)
    assert ts.same_csr(core.convert_to_csr(el, method=method, engine="jax"),
                       core.convert_to_csr(el, method=method))
    with pytest.raises(ValueError, match="engine"):
        core.convert_to_csr(el, method=method, engine="bogus")


# ---- the front door ----------------------------------------------------------

ENGINES = ["numpy", "threads", "pallas"]


def _engine_kw(engine):
    """The reference runs its Pallas parse through XLA on the CPU: small
    blocks keep its compile short."""
    return {"beta": 2048, "batch_blocks": 2} if engine == "pallas" else {}


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("front_door")
    path, v, oracle = ts.text_file(tmp, "g", seed=5, v=80, e=700,
                                   weighted=True, tail=4)
    return path, v, oracle


@pytest.mark.parametrize("engine", ENGINES)
def test_front_door_products_match_reference(graph, engine, tmp_path):
    path, v, oracle = graph
    kw = _engine_kw(engine)
    port = core.open_graph(path, engine=engine, weighted=True,
                           num_vertices=v, **kw, **CPU)
    ref = jcore.open_graph(path, engine=engine, weighted=True,
                           num_vertices=v, **kw)
    _same_el(port.edgelist(), ref.edgelist())
    csr = port.csr()
    assert csr.offsets.dtype == torch.int64
    assert ts.same_csr(csr, ref.csr()) and ts.same_csr(csr, oracle)
    dev = core.load_csr(path, weighted=True, num_vertices=v, **CPU)
    assert ts.same(csr.offsets, dev.offsets)
    assert ts.same(csr.targets, dev.targets)
    for rows in ((0, 1), (10, 40), (v - 4, v)):
        assert ts.same_csr(port.csr(rows=rows), ref.csr(rows=rows))
    for u in (0, 7, v - 5, v - 1):
        assert ts.same(port.neighbors(u), ref.neighbors(u))
        assert port.degree(u) == ref.degree(u)
    i, j = port.info(), ref.info()
    assert (i.format, i.num_edges, i.engine) == (j.format, j.num_edges,
                                                 j.engine)
    gv = port.save(str(tmp_path / "p.gvel"))
    ref.save(str(tmp_path / "r.gvel"))
    assert open(tmp_path / "p.gvel", "rb").read() == \
        open(tmp_path / "r.gvel", "rb").read()
    assert ts.same_csr(gv.csr(), csr)


@pytest.mark.parametrize("engine", ["numpy", "threads"])
@pytest.mark.parametrize("method", ["global", "staged", "binned"])
def test_load_and_read_csr_match_reference(graph, engine, method):
    path, v, oracle = graph
    for weighted, symmetric in ((False, False), (True, False), (True, True)):
        kw = dict(engine=engine, weighted=weighted, symmetric=symmetric,
                  method=method)
        got = core.load_csr(path, **kw, **CPU)
        assert ts.same_csr(got, jcore.load_csr(path, **kw))
        assert ts.same_csr(core.read_csr(path, **kw, **CPU),
                           jcore.read_csr(path, **kw))
        dev = core.load_csr(path, weighted=weighted, symmetric=symmetric,
                            method=method, **CPU)
        assert ts.same(got.offsets, dev.offsets)
        assert ts.same(got.targets, dev.targets)
    knob = {"num_workers": 3} if engine == "threads" else {"chunk_bytes": 997}
    _same_el(core.load_edgelist(path, engine=engine, **knob, **CPU),
             jcore.load_edgelist(path, engine=engine, **knob))


@pytest.mark.parametrize("engine", ENGINES)
def test_query_matches_reference(graph, engine):
    path, v, _ = graph
    kw = _engine_kw(engine)
    port, ref = SourceCache(), JCache()
    for op, args in (("neighbors", {"vertex": 9}), ("degree", {"vertex": 9}),
                     ("rows", {"rows": (5, 30)}), ("csr", {}),
                     ("edgelist", {})):
        got = port.query(path, op, engine=engine, **args, **kw, **CPU)
        want = ref.query(path, op, engine=engine, **args, **kw)
        if op == "degree":
            assert got == want
        elif op == "neighbors":
            assert ts.same(got, want)
        elif op == "edgelist":
            _same_el(got, want)
        else:
            assert ts.same_csr(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_read_mtx_matches_reference(engine, tmp_path):
    src, dst, w, v = _edges(6, True, v=40, e=300)
    w = np.round(w, 3)
    p = str(tmp_path / "g.mtx")
    core.write_mtx(p, src, dst, w, num_vertices=v, symmetric=True)
    kw = _engine_kw(engine)
    got = core.read_mtx(p, engine=engine, **kw, **CPU)
    want = jcore.read_mtx(p, engine=engine, **kw)
    _same_el(got, want)
    csr = core.open_graph(p, engine=engine, **kw, **CPU).csr()
    assert ts.same_csr(csr, jcore.open_graph(p, engine=engine, **kw).csr())
    assert ts.same_csr(core.mtx.read_mtx_csr(p, engine=engine, **CPU), csr)
    dev = core.open_graph(p, **CPU).csr()
    assert ts.same(csr.targets, dev.targets)


@pytest.mark.parametrize("engine", ["numpy", "threads"])
def test_host_engines_refuse_what_the_reference_refuses(graph, engine):
    path, _, _ = graph
    port = core.open_graph(path, engine=engine, **CPU)
    ref = jcore.open_graph(path, engine=engine)
    with pytest.raises(ValueError, match="no stream fast path") as a:
        port.stream()
    with pytest.raises(ValueError) as b:
        ref.stream()
    assert str(a.value) == str(b.value)
    with pytest.raises(ValueError, match="no sharded streaming path") as a:
        port.csr_sharded(None)
    from repro.core.compat import make_mesh
    with pytest.raises(ValueError) as b:
        ref.csr_sharded(make_mesh((1,), ("data",)))
    assert str(a.value) == str(b.value)


def test_tune_is_a_no_op_for_host_engines():
    for engine in ("numpy", "threads", "snapshot"):
        opts = core.LoadOptions(engine=engine, tune=True, device="cpu")
        assert core.loader.resolve_tuned(opts) is opts


def test_engine_table_matches_reference():
    assert core.available_engines() == jcore.available_engines()
    for name in core.available_engines():
        assert core.loader.csr_convert_engine(name) == (
            "numpy" if jcore.loader.csr_convert_engine(name) == "numpy"
            else "device")
    assert core.loader.DEFAULT_EDGELIST_ENGINE == "device"
    assert core.loader.DEFAULT_CSR_ENGINE == "device"


def test_int32_guards_name_the_host_engines():
    with pytest.raises(ValueError, match="engine='numpy'/'threads'"):
        core.loader._guard_int32_cap("big.el", 2**31)
    with pytest.raises(ValueError, match="engine='numpy' or 'threads'"):
        build._check_offsets_width(2**31)


# ---- the device rule -------------------------------------------------------------

def test_new_entry_points_need_cuda_without_device_cpu(graph, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the rule's CPU half: this machine has a CUDA device")
    path, v, _ = graph
    el = core.load_edgelist(path, **CPU)
    mtx = str(tmp_path / "g.mtx")
    core.write_mtx(mtx, el.src, el.dst, num_vertices=v)
    calls = [
        lambda: edgelist.read_edgelist_numpy(path),
        lambda: edgelist.read_edgelist_threads(path),
        lambda: edgelist.read_edgelist(path),
        lambda: core.load_edgelist(path, engine="numpy"),
        lambda: core.load_csr(path, engine="threads"),
        lambda: core.read_csr(path, engine="numpy"),
        lambda: core.open_graph(path, engine="numpy"),
        lambda: core.read_mtx(mtx, engine="numpy"),
        lambda: core.baselines.read_edgelist_naive(path),
        lambda: core.baselines.read_edgelist_loadtxt(path),
        lambda: core.baselines.read_edgelist_pigo(path),
        lambda: core.baselines.csr_pigo(el),
        lambda: types.csr_from_dense(np.eye(3, dtype=np.int64)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_no_default_path_reaches_a_host_engine(graph, monkeypatch):
    path, v, oracle = graph

    def named_only(*a, **kw):
        raise AssertionError("a host engine ran without being named")

    for name in ("numpy", "threads"):
        monkeypatch.setattr(core.get_engine(name), "_fn", named_only)
    g = core.open_graph(path, weighted=True, num_vertices=v, **CPU)
    assert ts.same_csr(g.csr(), oracle)
    g.edgelist()
    core.load_edgelist(path, symmetric=True, **CPU)
    core.load_csr(path, symmetric=True, **CPU)
    core.convert_to_csr(g.edgelist())


# ---- csr_from_dense ------------------------------------------------------------

@pytest.mark.parametrize("v", [0, 1, 6])
def test_csr_from_dense_matches_reference(v):
    adj = np.random.default_rng(v).integers(0, 3, (v, v))
    got = types.csr_from_dense(adj, **CPU)
    assert got.offsets.dtype == torch.int64 and got.targets.dtype == torch.int32
    assert ts.same_csr(got, jtypes.csr_from_dense(adj))
    assert np.array_equal(core.csr_to_dense(got), adj)
