"""The port's dry run (``launch/{mesh,counters,dryrun}.py``) on the CPU.

* ``make_production_mesh`` gives the reference's shapes and axis names in
  fake worlds of 256 and 512 ranks, and raises in a world of another
  size.
* The recorder files each ``c10d`` and ``_c10d_functional`` collective
  under the reference's keys with its result bytes, and
  ``collective_bytes`` sums them.
* Fake equals real: small cells of the reduced phi4-mini (the GSPMD step
  at ``fsdp=True``, ``local_zero1``, ``local_accum`` at ``fsdp=True``)
  and the reduced mixtral (GSPMD at ``fsdp=True``; a rank's 32 tokens of
  a microbatch are half a routing group) on a fake ``(2, 2)`` world give
  the calls and bytes per collective and the FLOPs of a real gloo
  ``(2, 2)`` world (``tests/torch_dryrun_world.py``) exactly, ranks 0 and
  3; ``argument_gb`` is that rank's state and batch bytes summed leaf by
  leaf.  Bytes accessed agree to ``BYTES_RTOL``: autograd copies a
  gradient into its accumulator where it cannot take the tensor over (a
  fake tensor's strides differ from the real kernel's, or another
  reference holds it), and which gradients it copies varies from run to
  run (seen: 0.03% of the reduced mixtral's bytes, 0.32% of a
  ``phi4_local_fsdp`` rank's).
* Full-config cells on the production meshes (fake CPU tensors): every
  key the reference's record has; the analytic terms, ``model_flops``,
  the parameter counts, ``tokens`` and ``meta`` are the reference's
  ``cell_cost``, ``default_accum`` and config numbers; a full-attention
  arch's ``long_500k`` is skipped with the reference's reason; the
  reference's ``benchmarks/roofline.py`` reads the record (its constants
  are a TPU's: no number of it is kept).
* The recurrent archs' train and prefill cells run their chunked scan: a
  reduced cell of three chunks counts ``repro.linear_scan``'s FLOPs (2 an
  element and step) and bytes accessed for every chunk, layer and pass.
* ``main`` writes the per-cell files and ``summary.json`` and returns 0,
  or 1 where a cell failed; ``--jobs 2`` runs the cells in worker
  processes.
* ``attention._sqrt_bf16`` (no tensor: a fake mode cannot intercept it)
  equals the old tensor rounding for every ``head_dim`` of the 10 configs.
"""
import importlib.util
import json
import math
import os
import sys
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh

import torch_dryrun_world as W
from repro import configs as jconfigs
from repro.launch import accounting as jacc
from repro.launch import shapes as jshapes
from repro_torch import configs
from repro_torch.launch import counters, dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.scripts import local_world

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
BYTES_RTOL = 1e-2
CELLS = {
    "phi4_gspmd_fsdp": dict(arch="phi4-mini-3.8b", seq=16, batch=8,
                            fsdp=True, accum=2),
    "phi4_local_zero1": dict(arch="phi4-mini-3.8b", seq=16, batch=8,
                             step_mode="local_zero1", accum=2),
    "phi4_local_fsdp": dict(arch="phi4-mini-3.8b", seq=16, batch=8,
                            step_mode="local_accum", fsdp=True, accum=2),
    "mixtral_gspmd_fsdp": dict(arch="mixtral-8x22b", seq=16, batch=8,
                               fsdp=True, accum=2),
}
FULL = {"phi4-mini-3.8b/decode_32k/single": {},
        "mixtral-8x22b/train_4k/single": {"accum": 1},
        "falcon-mamba-7b/long_500k/multi": {}}
# every key of the reference's record (src/repro/launch/dryrun.py)
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "status", "meta", "remat",
               "lower_s", "compile_s", "flops_per_device",
               "bytes_per_device", "collective_bytes_per_device",
               "collective_bytes_corrected", "analytic_flops_total",
               "analytic_bytes_per_device", "model_flops", "memory",
               "tokens", "kind", "param_count", "active_param_count"}
MEMORY_KEYS = {"argument_gb", "output_gb", "temp_gb", "alias_gb"}


@pytest.fixture
def world():
    """Starts a fake world of the size asked for, destroyed afterwards."""
    worlds = []

    def start(n, rank=0):
        cm = fake_world(n, rank=rank)
        cm.__enter__()
        worlds.append(cm)
    yield start
    for cm in worlds:
        cm.__exit__(None, None, None)
    assert not dist.is_initialized()


# ---- meshes -----------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_is_the_reference_s(world, multi_pod, shape, names):
    world(math.prod(shape), rank=5)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.mesh.shape) == shape
    assert tuple(mesh.mesh_dim_names) == names
    want = torch.arange(math.prod(shape)).view(shape).eq(5).nonzero()[0]
    assert list(mesh.get_coordinate()) == want.tolist()


@pytest.mark.parametrize("size,multi_pod", [(255, False), (512, False),
                                            (256, True)])
def test_production_mesh_needs_its_world(world, size, multi_pod):
    world(size)
    with pytest.raises(ValueError, match="ranks"):
        make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_a_fake_world_is_gone_after_its_block():
    with fake_world(4, like="nccl"):
        from repro_torch.distributed.collectives import is_nccl
        assert dist.get_world_size() == 4
        assert is_nccl(dist.group.WORLD)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        with fake_world(4):
            raise RuntimeError("inside")
    assert not dist.is_initialized()


# ---- the recorder -----------------------------------------------------------------

@pytest.mark.parametrize("op,key", [
    (torch.ops.c10d.allreduce_.default, "all-reduce"),
    (torch.ops.c10d.allgather_.default, "all-gather"),
    (torch.ops.c10d._allgather_base_.default, "all-gather"),
    (torch.ops.c10d.reduce_scatter_.default, "reduce-scatter"),
    (torch.ops.c10d._reduce_scatter_base_.default, "reduce-scatter"),
    (torch.ops.c10d.alltoall_base_.default, "all-to-all"),
    (torch.ops.c10d.alltoall_.default, "all-to-all"),
    (torch.ops.c10d.recv_.default, "collective-permute"),
    (torch.ops.c10d.broadcast_.default, "broadcast"),
    (torch.ops._c10d_functional.all_reduce.default, "all-reduce"),
    (torch.ops._c10d_functional.all_gather_into_tensor.default,
     "all-gather"),
    (torch.ops._c10d_functional.reduce_scatter_tensor.default,
     "reduce-scatter"),
    (torch.ops._c10d_functional.all_to_all_single.default, "all-to-all"),
    (torch.ops._c10d_functional.wait_tensor.default, None),
    (torch.ops.c10d.send.default, None),
    (torch.ops.aten.mm.default, None)])
def test_each_collective_op_has_the_reference_s_key(op, key):
    assert counters.kind_of(op) == key


def test_the_recorder_counts_result_bytes(world):
    """Each collective once, its bytes the result's: the output of a
    c10d op, the returned tensor of a functional one."""
    import torch.distributed._functional_collectives as fc
    world(4)
    with FakeTensorMode():
        x = torch.empty(6, 5)                       # 120 bytes
        with counters.Recorder() as rec:
            dist.all_reduce(x)
            parts = [torch.empty_like(x) for _ in range(4)]
            dist.all_gather(parts, x)                   # 480
            big = torch.empty(24, 5, dtype=torch.bfloat16)
            dist.all_gather_into_tensor(big, x.bfloat16())   # 240
            dist.reduce_scatter_tensor(x[:6].bfloat16(), big)  # 60
            dist.all_to_all_single(big, big.clone())        # 240
            dist.broadcast(x, src=0)                        # 120
            y = fc.all_reduce(x, "sum", dist.group.WORLD)   # 120
            fc.wait_tensor(y)
            torch.mm(x, x.T)
    assert rec.calls() == {"all-gather": 2, "all-reduce": 2, "all-to-all": 1,
                           "broadcast": 1, "reduce-scatter": 1}
    assert counters.collective_bytes(rec) == {
        "all-gather": 720, "all-reduce": 240, "all-to-all": 240,
        "broadcast": 120, "reduce-scatter": 60, "total": 1380}
    assert rec.flops == 2 * 6 * 5 * 6
    assert rec.peak >= 4 * 120 + 240


# ---- fake equals real ---------------------------------------------------------------

@pytest.fixture(scope="module")
def real_world(tmp_path_factory):
    """A real gloo ``(2, 2)`` world running every cell of ``CELLS``."""
    tmp = tmp_path_factory.mktemp("dryrun_world")
    (tmp / "spec.json").write_text(json.dumps({"mesh": [2, 2],
                                               "cells": CELLS}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]))
    runs = local_world.spawn(
        [sys.executable, os.path.join(HERE, "torch_dryrun_world.py"),
         str(tmp / "spec.json"), str(tmp)], 4, timeout=300, env=env,
        workdir=str(tmp))
    for k, run in enumerate(runs):
        assert run.returncode == 0, f"rank {k}:\n{run.stderr[-4000:]}"
    return [json.loads((tmp / f"rank{k}.json").read_text()) for k in range(4)]


@pytest.mark.parametrize("rank", (0, 3))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_fake_world_counts_what_a_real_one_does(world, real_world, cell,
                                                  rank):
    real = real_world[rank][cell]
    assert "error" not in real, real.get("error")
    world(4, rank=rank)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg, shape, kw = W.cell_of(**CELLS[cell])
    got = dryrun.measure_cell(cfg, shape, mesh, device="cpu", **kw)
    assert got["collective_calls_per_device"] == \
        real["collective_calls_per_device"]
    assert got["collective_bytes_per_device"] == \
        real["collective_bytes_per_device"]
    assert got["collective_bytes_corrected"] == \
        got["collective_bytes_per_device"]
    assert got["flops_per_device"] == real["flops_per_device"] > 0
    assert got["flops_by_op_per_device"] == real["flops_by_op_per_device"]
    assert got["bytes_per_device"] == pytest.approx(
        real["bytes_per_device"], rel=BYTES_RTOL)
    assert got["memory"]["argument_gb"] * 1e9 == pytest.approx(
        real["leaf_bytes"], abs=0.5)
    assert got["memory"]["argument_gb"] == real["memory"]["argument_gb"]
    kinds = set(got["collective_calls_per_device"])
    assert kinds >= ({"all-gather", "all-reduce"} if "fsdp" in cell
                     else {"all-reduce"}), kinds


# ---- full-config cells on the production meshes ------------------------------------

@pytest.fixture(scope="module")
def full_cells():
    out = {}
    for key, kw in FULL.items():
        arch, shape, mesh = key.split("/")
        out[key] = dryrun.run_cell(arch, shape, mesh == "multi",
                                   device="cpu", verbose=False, **kw)
        assert not dist.is_initialized()
    return out


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline_of_the_reference",
        os.path.join(ROOT, "benchmarks", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("key", sorted(FULL))
def test_a_full_cell_s_record_has_the_reference_s_keys(full_cells, key):
    rec = full_cells[key]
    assert rec["status"] == "ok", rec
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    for k in ("flops_per_device", "bytes_per_device"):
        assert rec[k] > 0, k
    assert sum(rec["flops_by_op_per_device"].values()) == \
        rec["flops_per_device"]
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert set(coll) - {"total"} <= set(counters.COLLECTIVES)
    assert rec["collective_bytes_corrected"] == coll
    assert rec["memory"]["argument_gb"] > 0 and rec["memory"]["temp_gb"] > 0
    json.dumps(rec)
    row = _roofline().analyze(rec)
    assert row["arch"] == rec["arch"] and row["dominant"] in (
        "compute", "memory", "collective")


@pytest.mark.parametrize("key", sorted(FULL))
def test_a_full_cell_s_analytic_terms_are_the_reference_s(full_cells, key):
    arch, shape, mesh = key.split("/")
    rec = full_cells[key]
    jcfg = jconfigs.get_config(arch)
    sc = jshapes.SHAPES[shape]
    axes = ({"pod": 2, "data": 16, "model": 16} if mesh == "multi"
            else {"data": 16, "model": 16})
    chips = math.prod(axes.values())
    accum = FULL[key].get("accum")
    if sc.kind == "train" and accum is None:
        accum = jshapes.default_accum(jcfg, shape,
                                      SimpleNamespace(shape=axes))
    fsdp = arch in jconfigs.FSDP_ARCHS
    want = jacc.cell_cost(jcfg, 16, chips, seq=sc.seq,
                          batch=sc.global_batch, kind=sc.kind,
                          accum=accum or 1, remat="full", fsdp=fsdp)
    assert rec["chips"] == chips
    assert rec["analytic_flops_total"] == want.flops_total
    assert rec["analytic_bytes_per_device"] == want.bytes_per_device
    assert rec["model_flops"] == want.model_flops
    assert rec["param_count"] == jcfg.param_count()
    assert rec["active_param_count"] == jcfg.active_param_count()
    assert rec["tokens"] == (sc.global_batch if sc.kind == "decode"
                             else sc.seq * sc.global_batch)
    assert rec["kind"] == sc.kind
    meta = {"fsdp": fsdp}
    if sc.kind == "train":
        meta.update(accum=accum, step_mode="gspmd")
    assert rec["meta"] == meta


FULL_ATTENTION = [a for a in sorted(jconfigs.ARCHS)
                  if not jshapes.cell_enabled(jconfigs.get_config(a),
                                              "long_500k")]


@pytest.mark.parametrize("arch", FULL_ATTENTION)
def test_long_500k_of_a_full_attention_arch_is_skipped(arch):
    assert not configs.get_config(arch).sub_quadratic
    with open(os.path.join(ROOT, "src", "repro", "launch",
                           "dryrun.py")) as f:
        assert f'"reason": "{dryrun.SKIP_REASON}"' in f.read()
    for multi in (False, True):
        rec = dryrun.run_cell(arch, "long_500k", multi, device="cpu")
        assert rec == {"arch": arch, "shape": "long_500k",
                       "mesh": "multi" if multi else "single",
                       "status": "skipped", "reason": dryrun.SKIP_REASON}


@pytest.mark.parametrize("arch,shape", [
    ("recurrentgemma-2b", "train_4k"), ("recurrentgemma-2b", "prefill_32k"),
    ("falcon-mamba-7b", "train_4k"), ("falcon-mamba-7b", "prefill_32k")])
def test_a_recurrent_cell_runs_its_chunked_scan(world, arch, shape):
    """The recurrent archs' train and prefill cells run (the port's layers
    once stepped each token eagerly, and the dry run skipped them).  The
    reduced arch at this cell's kind, 768 tokens (3 chunks of 256) and 4
    rows on a fake ``(2, 2)`` world: every recurrent layer scans each
    chunk of its rank's 2 rows over its local channels once a pass
    (forward; at ``remat="full"`` also the recompute and the reversed
    scan of the backward), 2 FLOPs an element and step, and reads ``a``,
    ``b`` and ``h0`` and writes ``h`` once (f32)."""
    from repro_torch.launch.shapes import ShapeCase
    from repro_torch.models.blocks import layer_kinds
    world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = configs.reduced_config(arch)
    kind = jshapes.SHAPES[shape].kind
    rec = dryrun.measure_cell(cfg, ShapeCase(shape, 768, 4, kind), mesh,
                              device="cpu",
                              **({"accum": 1} if kind == "train" else {}))
    channels = (cfg.lru_width // 2 if arch.startswith("recurrent")
                else cfg.d_inner // 2 * cfg.ssm.d_state)
    layers = sum(k in ("rglru", "mamba") for k in layer_kinds(cfg))
    calls = layers * 3 * (3 if kind == "train" else 1)
    rows, steps = 2, 256
    assert rec["flops_by_op_per_device"]["repro.linear_scan"] == \
        calls * 2 * rows * steps * channels
    assert rec["bytes_by_op_per_device"]["repro.linear_scan"] == \
        calls * 4 * (3 * rows * steps * channels + rows * channels)
    assert rec["flops_per_device"] > rec["flops_by_op_per_device"][
        "repro.linear_scan"] > 0
    assert rec["memory"]["temp_gb"] > 0


# ---- main ------------------------------------------------------------------------

def test_main_writes_each_cell_and_the_summary(tmp_path, capsys):
    out = tmp_path / "art"
    code = dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
                        "--mesh", "both", "--device", "cpu", "--out",
                        str(out)])
    assert code == 0
    summary = json.loads((out / "summary.json").read_text())
    assert [(r["mesh"], r["status"], r["chips"]) for r in summary] == [
        ("single", "ok", 256), ("multi", "ok", 512)]
    for r in summary:
        path = out / f"phi4-mini-3.8b__decode_32k__{r['mesh']}.json"
        assert json.loads(path.read_text()) == r
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == "dry-run: 2 ok, 0 skipped, 0 failed / 2 cells"


def test_main_returns_1_where_a_cell_fails(tmp_path, capsys):
    out = tmp_path / "art"
    code = dryrun.main(["--arch", "falcon-mamba-7b", "--shape", "no_such",
                        "--mesh", "both", "--device", "cpu", "--jobs", "2",
                        "--out", str(out)])
    assert code == 1
    summary = json.loads((out / "summary.json").read_text())
    assert [r["status"] for r in summary] == ["failed", "failed"]
    assert "no_such" in summary[0]["error"]
    assert (out / "falcon-mamba-7b__no_such__multi.json").exists()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == "dry-run: 0 ok, 0 skipped, 2 failed / 2 cells"
    assert not dist.is_initialized()


# ---- the bf16 constant --------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_sqrt_bf16_is_the_tensor_rounding(arch):
    from repro_torch.models import attention
    hds = {configs.get_config(arch).head_dim,
           configs.reduced_config(arch).head_dim} - {None}
    for hd in hds:
        want = float(torch.tensor(math.sqrt(hd), dtype=torch.float32)
                     .to(torch.bfloat16))
        attention._sqrt_bf16.cache_clear()
        with FakeTensorMode():
            assert attention._sqrt_bf16(hd) == want, hd
    assert all(attention._sqrt_bf16(h) == float(
        torch.tensor(math.sqrt(h)).to(torch.bfloat16)) for h in range(1, 513))
