"""The port's sharded streaming load held against the JAX package's on the
CPU (``tests/test_sharded_stream.py``), at tolerance 0.

The pieces that need no mesh run in-process in both packages: the shard
plan, the per-shard block sources, ``_cap_round`` and the owner bucketing
(the reference's ``exchange_by_owner`` under ``jax.vmap`` with an axis
name; the port's ``bucket_by_owner`` per rank, its exchange emulated).

The end-to-end matrix runs twice on the same files: in a 4-rank gloo world
of the port (``tests/torch_sharded_world.py``, spawned with a ``file://``
rendezvous under ``tmp_path``) and, at the same time, through the JAX
package on 4 forced host devices (the ``devices4`` subprocess).  Rank k's
rows must equal row k of the reference's ``(d, .)`` offsets, targets and
weights, bitwise, dtypes included.
"""
import gzip
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import blocks as jblocks
from repro.core import codecs as jcodecs
from repro.core import distributed as jdist
from repro_torch.core import (blocks, codecs, distributed, save_snapshot,
                              write_framed)
from repro_torch.core.types import EdgeList
from repro_torch.scripts import local_world

import torch_serving as ts

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
WORLD = 4

# ---- the shard plan ------------------------------------------------------------


@pytest.mark.parametrize("nbytes,beta,d", [
    (100_000, 2048, 4), (100_000, 2048, 3), (1_000, 256, 7),
    (50, 4096, 4), (0, 1024, 2), (8192, 1024, 8),
])
def test_shard_plan_matches_reference(nbytes, beta, d):
    plan = blocks.plan_blocks(nbytes, beta=beta, overlap=64)
    jplan = jblocks.plan_blocks(nbytes, beta=beta, overlap=64)
    spans = [blocks.shard_plan(plan, k, d) for k in range(d)]
    for k, span in enumerate(spans):
        want = jblocks.shard_plan(jplan, k, d)
        for field in ("shard", "num_shards", "block_lo", "block_hi",
                      "num_blocks", "byte_lo", "byte_hi", "edge_cap"):
            assert getattr(span, field) == getattr(want, field), (k, field)
    # disjoint, ordered, covering, balanced to within one block
    assert spans[0].block_lo == 0 and spans[-1].block_hi == plan.num_blocks
    assert all(a.block_hi == b.block_lo for a, b in zip(spans, spans[1:]))
    sizes = [s.num_blocks for s in spans]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("k,d", [(0, 0), (2, 2), (-1, 2)])
def test_shard_plan_refuses_what_the_reference_refuses(k, d):
    plan = blocks.plan_blocks(1000, beta=256, overlap=64)
    with pytest.raises(ValueError) as got:
        blocks.shard_plan(plan, k, d)
    with pytest.raises(ValueError) as want:
        jblocks.shard_plan(jblocks.plan_blocks(1000, beta=256, overlap=64),
                           k, d)
    assert str(got.value) == str(want.value)


# ---- per-shard block sources ------------------------------------------------------

def _lines(n, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(1, 900, n), rng.integers(1, 900, n)
    return ("\n".join(f"{s} {d}" for s, d in zip(src, dst)) + "\n").encode()


def _encoded(tmp_path, data, fmt):
    if fmt == "raw":
        path = tmp_path / "g.el"
        path.write_bytes(data)
    elif fmt == "gzip":
        path = tmp_path / "g.el.gz"
        path.write_bytes(gzip.compress(data))
    else:
        path = tmp_path / "g.el.fz"
        write_framed(str(path), data, codec="zlib", frame_beta=4096)
    return str(path)


@pytest.mark.parametrize("fmt", ["raw", "gzip", "framed-zlib"])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_shard_source_staging_matches_reference(tmp_path, fmt, d):
    data = _lines(3000, seed=2)
    path = _encoded(tmp_path, data, fmt)
    length, forced = codecs.stream_geometry(path)
    assert (length, forced) == jcodecs.stream_geometry(path)
    plan = blocks.plan_blocks(length, beta=forced or 2048, overlap=64)
    jplan = jblocks.plan_blocks(length, beta=forced or 2048, overlap=64)
    for k in range(d):
        span = blocks.shard_plan(plan, k, d)
        jspan = jblocks.shard_plan(jplan, k, d)
        if span.num_blocks == 0:
            with pytest.raises(ValueError, match="owns no blocks"):
                codecs.open_shard_block_source(path, plan, span)
            continue
        got = codecs.open_shard_block_source(path, plan, span)
        want = jcodecs.open_shard_block_source(path, jplan, jspan)
        for lo in range(span.block_lo, span.block_hi, 3):
            ids = np.arange(lo, min(lo + 3, span.block_hi))
            flat = got.stage(plan, ids)
            assert np.array_equal(blocks.block_view(flat, plan),
                                  want.stage(jplan, ids)), (fmt, k, lo)
        got.finish()
        want.finish()


@pytest.mark.parametrize("k,d,match", [
    (1, 3, "before this shard span"),   # a mid-stream span: coverage
    (1, 2, "expected"),                 # the tail span: the exact total
])
def test_span_source_truncated_stream_raises(k, d, match):
    data = b"1 2\n3 4\n5 6\n" * 400
    plan = blocks.plan_blocks(len(data), beta=256, overlap=64)
    span = blocks.shard_plan(plan, k, d)
    start = max(span.block_lo * plan.beta - plan.overlap, 0)

    def sources(mod):
        # begins at the span's left margin, ends short of span.byte_hi
        return mod.SequentialBlockSource(
            iter([data[start:span.byte_hi - 40]]), len(data), start=start,
            end=span.byte_hi if span.block_hi < plan.num_blocks else None,
            first_block=span.block_lo)

    errors = []
    for mod, p in ((blocks, plan), (jblocks, jblocks.plan_blocks(
            len(data), beta=256, overlap=64))):
        src = sources(mod)
        with pytest.raises(ValueError, match=match) as exc:
            for lo in range(span.block_lo, span.block_hi, 4):
                src.stage(p, np.arange(lo, min(lo + 4, span.block_hi)))
            src.finish()
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_span_source_rejects_out_of_order():
    data = b"1 2\n" * 500
    plan = blocks.plan_blocks(len(data), beta=256, overlap=64)
    src = blocks.SequentialBlockSource(iter([data]), len(data),
                                       first_block=0)
    src.stage(plan, np.arange(0, 2))
    with pytest.raises(ValueError, match="out of order"):
        src.stage(plan, np.arange(5, 6))
    mid = blocks.SequentialBlockSource(iter([data[192:]]), len(data),
                                       start=192, first_block=1)
    with pytest.raises(ValueError, match="expected 1"):
        mid.stage(plan, np.arange(0, 1))


# ---- _cap_round and the bucketing -----------------------------------------------

def test_cap_round_matches_reference():
    for n in range(0, 10_001):
        assert distributed._cap_round(n) == jdist._cap_round(n), n


@pytest.mark.parametrize("d,e,rows,cap,weighted", [
    (1, 40, 50, 40, False), (3, 50, 10, 9, True), (4, 200, 7, 64, True),
    (4, 200, 7, 5, False), (2, 64, 100, 64, True),
])
def test_bucketing_matches_reference(d, e, rows, cap, weighted):
    """The reference's exchange under ``jax.vmap`` (axis ``x``) against the
    port's per-rank buckets, their exchange emulated: the same received
    slots, counts and overflow.  Ids past ``d * rows`` are dropped by both
    without counting as overflow."""
    rng = np.random.default_rng(d * 1000 + e + cap)
    src = rng.integers(-1, d * rows + 3, (d, e)).astype(np.int32)
    src[:, -3:] = -1                                # a padding tail
    dst = rng.integers(0, 500, (d, e)).astype(np.int32)
    w = rng.random((d, e)).astype(np.float32) if weighted else None
    ref = jax.vmap(lambda s, dd, ww: jdist.exchange_by_owner(
        s, dd, ww, num_shards=d, rows_per_shard=rows, axis="x",
        send_cap=cap), axis_name="x")(src, dst, w)
    snd = [distributed.bucket_by_owner(
        torch.from_numpy(src[k]), torch.from_numpy(dst[k]),
        None if w is None else torch.from_numpy(w[k]), num_shards=d,
        rows_per_shard=rows, send_cap=cap) for k in range(d)]
    for k in range(d):
        mine = slice(k * cap, (k + 1) * cap)
        rcv = [torch.cat([snd[j][i][mine] for j in range(d)]).numpy()
               for i in (0, 1) + ((2,) if weighted else ())]
        assert np.array_equal(rcv[0], np.asarray(ref[0][k]))
        assert np.array_equal(rcv[1], np.asarray(ref[1][k]))
        if weighted:
            assert ts.same(rcv[2], np.asarray(ref[2][k]))
        assert int((rcv[0] >= 0).sum()) == int(ref[3][k])
        assert snd[k][3].dtype == torch.int32
        assert int(snd[k][3]) == int(ref[4][k])
    assert snd[0][0].dtype == torch.int32


# ---- the end-to-end matrix: a 4-rank port world beside the reference's ------------

def _write_text(path, src, dst, w=None, base=1):
    if w is None:
        body = "\n".join(f"{s + base} {d + base}" for s, d in zip(src, dst))
    else:
        body = "\n".join(f"{s + base} {d + base} {x:.3f}"
                         for s, d, x in zip(src, dst, w))
    with open(path, "w") as f:
        f.write(body + "\n")
    return str(path)


def _matrix(tmp):
    """The cases, as data both worlds read: the reference's parity matrix
    (weighted x base x codec at beta=2048), both sharded builds, a mesh
    wider than a 2-line file, an indivisible V with zero-edge shards, a
    send_cap overflow, ``host_shard_and_load``, a shard re-execution, and
    the front door's refusals."""
    rng = np.random.default_rng(11)
    n, v = 4000, 333
    src, dst = rng.integers(0, v, n), rng.integers(0, v, n)
    w = (rng.random(n) * 9).round(3).astype(np.float32)
    cases, files = [], {}
    for weighted in (False, True):
        for base in (0, 1):
            raw = _write_text(tmp / f"g_{int(weighted)}_{base}.el", src, dst,
                              w if weighted else None, base)
            data = open(raw, "rb").read()
            with open(raw + ".gz", "wb") as f:
                f.write(gzip.compress(data))
            write_framed(raw + ".fz", data, codec="zlib", frame_beta=4096)
            for codec, path in (("raw", raw), ("gzip", raw + ".gz"),
                                ("framed", raw + ".fz")):
                files[(weighted, base, codec)] = path
                cases.append({"name": f"w{int(weighted)}_b{base}_{codec}",
                              "kind": "open", "path": path,
                              "open": {"weighted": weighted, "base": base,
                                       "beta": 2048}})
    cases.append({"name": "binned_w1_raw", "kind": "open",
                  "path": files[(True, 1, "raw")],
                  "open": {"weighted": True, "beta": 2048},
                  "call": {"method": "binned"}})
    cases.append({"name": "binned_w0_gzip", "kind": "open",
                  "path": files[(False, 0, "gzip")],
                  "open": {"base": 0, "beta": 2048, "method": "binned"}})
    cases.append({"name": "staged_rho2_framed", "kind": "open",
                  "path": files[(False, 1, "framed")],
                  "open": {"beta": 2048}, "call": {"rho": 2}})
    tiny = tmp / "tiny.el"
    tiny.write_text("1 2\n2 1\n")
    cases.append({"name": "tiny", "kind": "open", "path": str(tiny)})
    # each rank asks for another beta (as ranks that tuned apart might):
    # every rank plans with rank 0's
    cases.append({"name": "rank0_geometry", "kind": "open",
                  "path": files[(True, 0, "gzip")],
                  "open": {"weighted": True, "base": 0},
                  "rank_beta": [2048, 4096, 1024, 8192]})
    r5 = np.random.default_rng(5)
    lop = _write_text(tmp / "lop.el", r5.integers(0, 6, 600),
                      r5.integers(0, 6, 600))
    cases.append({"name": "indivisible", "kind": "open", "path": lop,
                  "open": {"num_vertices": 13, "beta": 1024}})
    hub = tmp / "hub.el"
    hub.write_text("".join(f"1 {i % 40 + 1}\n" for i in range(400)))
    cases.append({"name": "overflow", "kind": "stream", "path": str(hub),
                  "open": {"num_vertices": 40, "send_cap": 1}})
    r9 = np.random.default_rng(9)
    c = _write_text(tmp / "c.el", r9.integers(0, 128, 2000),
                    r9.integers(0, 128, 2000))
    cases.append({"name": "host_shard", "kind": "host_shard", "path": c,
                  "open": {"num_vertices": 128}})
    cases.append({"name": "host_shard_weighted", "kind": "host_shard",
                  "path": files[(True, 1, "raw")],
                  "open": {"num_vertices": v, "weighted": True}})
    cases.append({"name": "shard_reexec", "kind": "faulty",
                  "path": files[(False, 1, "raw")], "open": {"beta": 2048},
                  "faults": [{"site": "block", "kind": "oserror",
                              "index": 0, "times": 3}]})
    mtx = tmp / "g.mtx"
    mtx.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                   "3 3 2\n1 2\n2 3\n")
    cases.append({"name": "refuse_mtx", "kind": "open", "path": str(mtx)})
    gv = tmp / "g.gvel"
    save_snapshot(str(gv), edgelist=EdgeList(
        torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor([1, 2], dtype=torch.int32), None, 2, 3))
    cases.append({"name": "refuse_gvel", "kind": "open", "path": str(gv)})
    cases.append({"name": "refuse_symmetric", "kind": "open",
                  "path": str(tiny), "open": {"symmetric": True}})
    cases.append({"name": "refuse_axis", "kind": "via", "path": str(tiny),
                  "open": {"engine": "device"}, "call": {"axis": "model"}})
    cases.append({"name": "refuse_engine", "kind": "via", "path": str(tiny),
                  "open": {"engine": "numpy"}})
    return cases


_REFERENCE = """
import json, os, sys
import numpy as np
from repro.core import FaultPlan, FaultSpec, host_shard_and_load, open_graph
from repro.core import distributed
from repro.core.compat import make_mesh
from repro.core.loader import LoadOptions, read_csr_sharded_via

spec, out = sys.argv[1], sys.argv[2]
mesh = make_mesh((4,), ("data",))
errors = {}
for case in json.load(open(spec)):
    name, kind, path = case["name"], case["kind"], case["path"]
    kw = dict(case.get("open", {}))
    if "rank_beta" in case:
        kw["beta"] = case["rank_beta"][0]
    call = case.get("call", {})
    try:
        if kind == "open":
            csr = open_graph(path, engine="device", **kw).csr_sharded(
                mesh, **call)
        elif kind == "faulty":
            plan = FaultPlan([FaultSpec(**f) for f in case["faults"]], seed=7)
            csr = open_graph(path, engine="device", faults=plan,
                             **kw).csr_sharded(mesh)
        elif kind == "stream":
            csr = distributed.load_csr_sharded_stream(mesh, "data", path,
                                                      **kw)
        elif kind == "host_shard":
            csr = host_shard_and_load(mesh, "data", path, **kw)
        else:
            csr = read_csr_sharded_via(path, LoadOptions(**kw), mesh=mesh,
                                       **call)
    except (ValueError, RuntimeError) as exc:
        errors[name] = [type(exc).__name__, str(exc)]
        continue
    arrays = {"offsets": np.asarray(csr.offsets),
              "targets": np.asarray(csr.targets),
              "meta": np.array([csr.num_vertices, csr.row_start])}
    if csr.weights is not None:
        arrays["weights"] = np.asarray(csr.weights)
    np.savez(os.path.join(out, "ref_" + name + ".npz"), **arrays)
json.dump(errors, open(os.path.join(out, "ref_errors.json"), "w"))
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, devices4):
    """Both worlds over one matrix, run at the same time; returns
    ``(cases, out_dir, per-rank reports)``."""
    tmp = tmp_path_factory.mktemp("sharded")
    cases = _matrix(tmp)
    spec = tmp / "spec.json"
    spec.write_text(json.dumps(cases))
    out = tmp / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]))
    env.pop("REPRO_FAULTS", None)
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(local_world.spawn, [
            sys.executable, os.path.join(HERE, "torch_sharded_world.py"),
            str(spec), str(out)], WORLD, timeout=300, env=env,
            workdir=str(tmp))
        ref_code = (f"import sys\nsys.argv = ['ref', {str(spec)!r}, "
                    f"{str(out)!r}]\n" + _REFERENCE)
        assert "REFERENCE-OK" in devices4(ref_code, timeout=400)
        runs = port.result()
    for k, run in enumerate(runs):
        assert run.returncode == 0, f"rank {k}:\n{run.stdout}{run.stderr}"
    reports = [json.loads((out / f"rank{k}.json").read_text())
               for k in range(WORLD)]
    return cases, out, reports


LOADS = [f"w{w}_b{b}_{c}" for w in (0, 1) for b in (0, 1)
         for c in ("raw", "gzip", "framed")] + [
    "binned_w1_raw", "binned_w0_gzip", "staged_rho2_framed", "tiny",
    "rank0_geometry",
    "indivisible", "host_shard", "host_shard_weighted", "shard_reexec"]


@pytest.mark.parametrize("name", LOADS)
def test_sharded_rows_match_reference(worlds, name):
    _cases, out, reports = worlds
    assert all(name not in r["errors"] for r in reports), \
        [r["errors"].get(name) for r in reports]
    ref = np.load(out / f"ref_{name}.npz")
    rows = ref["offsets"].shape[1] - 1
    for k in range(WORLD):
        got = np.load(out / f"{name}_{k}.npz")
        for key in ("offsets", "targets"):
            assert got[key].dtype == ref[key].dtype, (k, key)
            assert np.array_equal(got[key], ref[key][k]), (k, key)
        assert ("weights" in got) == ("weights" in ref)
        if "weights" in ref:
            assert got["weights"].dtype == np.float32
            assert ts.same(got["weights"], ref["weights"][k]), k
        assert got["meta"].tolist() == [int(ref["meta"][0]), k * rows]


def test_overflow_raises_on_every_rank(worlds):
    _cases, out, reports = worlds
    ref = json.loads((out / "ref_errors.json").read_text())["overflow"]
    assert ref[0] == "ValueError" and "overflow" in ref[1]
    for r in reports:
        kind, msg = r["errors"]["overflow"]
        assert kind == "ValueError"
        assert msg.startswith("exchange_by_owner overflow: ")
        assert "send_cap=1" in msg


@pytest.mark.parametrize("name,match", [
    ("refuse_mtx", "MTX"), ("refuse_gvel", "snapshot"),
    ("refuse_symmetric", "symmetric"), ("refuse_axis", "no axis"),
    ("refuse_engine", "no sharded streaming path")])
def test_front_door_refusals_match_reference(worlds, name, match):
    """The same ``ValueError`` on every rank, with the reference's
    message."""
    _cases, out, reports = worlds
    ref = json.loads((out / "ref_errors.json").read_text())[name]
    assert ref[0] == "ValueError" and match in ref[1]
    for r in reports:
        kind, msg = r["errors"][name]
        assert kind == "ValueError" and match in msg
        assert msg == ref[1]


def test_shard_reexec_counts_one_retry_on_the_failed_shard(worlds):
    _cases, _out, reports = worlds
    retries = [r["counters"]["shard_reexec"]["shard_retries"]
               for r in reports]
    assert retries == [1, 0, 0, 0]
    assert [r["counters"]["w0_b1_raw"]["shard_retries"]
            for r in reports] == [0] * WORLD
    assert not dist.is_initialized()      # the worlds ran in other processes


def test_csr_sharded_is_memoized_per_rho(worlds):
    _cases, _out, reports = worlds
    assert all(r["memo"] == [True, True] for r in reports)
