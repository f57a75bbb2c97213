"""The dry run: every (arch x shape x mesh) cell's step run once on a
fake world of the production mesh; the port of ``repro/launch/
dryrun.py``.

The reference forces 512 host devices, lowers and compiles each cell's
step against abstract inputs and records what the compiled program says.
The port has no lowering and no compile.  :func:`run_cell` starts a world
of the ``fake`` backend of 256 or 512 ranks in this process
(``launch.mesh.fake_world``: every collective returns at once), builds
the production mesh over it and the cell (:func:`build_cell`, on the
``meta`` device), makes the arguments fake tensors of ``device``
(``FakeTensorMode``: shapes, dtypes and devices, no storage; on the card
``cuda``, so code that asks for the device takes the card's branch) and
runs the step once as rank 0 under ``launch.counters.Recorder``
(:func:`measure_cell`, which the tests call on a smaller config and
mesh).

The record has the reference's keys:

* ``flops_per_device`` and ``bytes_per_device``: the recorder's FLOPs and
  bytes accessed;
* ``collective_bytes_per_device`` and ``collective_bytes_corrected``: both
  the recorder's result bytes per collective.  The reference fills them
  from the raw HLO (each while body once) and from ``hlo.py``'s
  trip-corrected count; eager execution runs every layer, microbatch and
  recompute as itself, so its raw count is the corrected one;
* ``analytic_flops_total``, ``analytic_bytes_per_device`` and
  ``model_flops``: ``accounting.cell_cost``;
* ``memory``: ``argument_gb`` (the storage of the arguments this rank
  holds), ``output_gb`` (of the outputs), ``alias_gb`` (of the outputs
  that are the arguments' storage: the in-place update) and ``temp_gb``
  (the peak of the storage the step allocated beyond its arguments);
* ``lower_s``: :func:`build_cell`'s seconds; ``compile_s``: the fake
  step's (nothing is compiled: it is the time the step takes to trace).

and ``collective_calls_per_device`` (the calls per collective),
``flops_by_op_per_device``, ``bytes_by_op_per_device`` and ``device``
besides.  Skipped cells are the reference's
(``shapes.cell_enabled``), with its reason.

Usage::

  python -m repro_torch.launch.dryrun --arch mixtral-8x22b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch

from . import counters

BF16 = torch.bfloat16
F32 = torch.float32
LOCAL_MODES = ("local_accum", "local_accum_int8", "local_zero1")
SKIP_REASON = "full attention arch; long_500k documented skip"


def build_cell(cfg, shape, mesh, *, remat_policy="full",
               accum: int | None = None, fsdp: bool | None = None,
               step_mode: str = "gspmd"):
    """Returns ``(fn, args, meta)``: the step of ``shape``'s kind (a name
    in ``shapes.SHAPES`` or a ``ShapeCase``) on this rank of ``mesh`` (a
    ``DeviceMesh`` with a ``"model"`` axis and data axes), its arguments
    (``(state, batch)``, ``(model, batch)`` or ``(model, caches,
    batch)``; the batch global, the rest this rank's pieces) on the
    ``meta`` device (every shape and dtype, no storage: the reference's
    ``ShapeDtypeStruct``s) and ``{"accum", "fsdp", "step_mode"}`` (train)
    or ``{"fsdp"}``.  Its defaults are the reference's: ``fsdp`` for
    ``FSDP_ARCHS``, a bf16 state for ``BF16_STATE_ARCHS``,
    ``shapes.default_accum``.

    * train: ``train.step.make_train_step(..., mesh=mesh)`` (``gspmd``)
      on ``init_state(model, mesh=mesh)``, or the local-accumulation step
      of ``step_mode`` (at ``fsdp=True`` it gathers the pieces whole at
      entry, as the reference's ``shard_map`` does);
    * prefill and decode: ``serve.step``'s steps with ``mesh`` on a bf16
      serving model (every leaf bf16 for a bf16-state arch), the decode's
      caches this rank's rows and pieces.

    The model is ``Transformer(cfg, tp=...)`` on the ``meta`` device,
    sharded by ``shard_model(..., fsdp=fsdp)``."""
    from ..configs import BF16_STATE_ARCHS, FSDP_ARCHS
    from ..distributed import tensor_parallel as tpar
    from ..distributed.sharding import batch_axes, mesh_axes
    from ..models.transformer import Transformer, init_caches
    from ..serve.step import make_decode_step, make_prefill_step
    from ..train.optimizer import OptimizerConfig
    from ..train.state import cast_model, init_state
    from .shapes import case_of, default_accum, input_specs

    sc = case_of(shape)
    axes = mesh_axes(mesh)
    tp = axes.get("model", 1)
    if fsdp is None:
        fsdp = cfg.name in FSDP_ARCHS
    bf16_state = cfg.name in BF16_STATE_ARCHS
    train = sc.kind == "train"
    model = Transformer(cfg, tp=tp, device="meta",
                        dtype=F32 if train else BF16)
    if bf16_state:
        cast_model(model, BF16)
        if not train:
            model.requires_grad_(False)
    tpar.shard_model(model, cfg, mesh, fsdp=fsdp)
    batch = input_specs(cfg, shape)

    if train:
        if accum is None:
            accum = default_accum(cfg, shape, mesh)
        oc = OptimizerConfig()
        meta = {"accum": accum, "fsdp": fsdp, "step_mode": step_mode}
        if step_mode == "gspmd":
            from ..train.step import make_train_step
            step = make_train_step(cfg, oc, remat_policy=remat_policy,
                                   accum_steps=accum, mesh=mesh)
            return step, (init_state(model, mesh=mesh), batch), meta
        if step_mode not in LOCAL_MODES:
            raise ValueError(f"unknown step_mode {step_mode!r}")
        from ..distributed.sharding import dp_axes
        from ..train.step import (make_local_accum_train_step,
                                  make_zero1_local_state)
        zero1 = step_mode == "local_zero1"
        step = make_local_accum_train_step(
            cfg, oc, mesh, remat_policy=remat_policy, accum_steps=accum,
            int8_allreduce=step_mode.endswith("int8"), zero1=zero1,
            batch_axes=("data",) if zero1 else dp_axes(axes))
        state = make_zero1_local_state(model, axes["data"], tp, mesh=mesh) \
            if zero1 else init_state(model)
        return step, (state, batch), meta

    if sc.kind == "prefill":
        step = make_prefill_step(cfg, sc.seq, tp=tp, mesh=mesh)
        return step, (model, batch), {"fsdp": fsdp}

    ba = batch_axes(axes, sc.global_batch)
    rows = sc.global_batch
    for a in ba or ():
        rows //= axes[a]
    caches = init_caches(cfg, rows, sc.seq, device="meta", tp=tp)
    step = make_decode_step(cfg, sc.seq, tp=tp, mesh=mesh)
    return step, (model, caches, batch), {"fsdp": fsdp}


# ---- the fake step ---------------------------------------------------------

def materialize(tree, device, *, seed: int | None = None):
    """``tree`` (:func:`build_cell`'s arguments) with every tensor on
    ``device``: empty (fake ones under a ``FakeTensorMode``) or, with
    ``seed``, real ones drawn from it (floats uniform in ``[0, 0.02)``,
    integers zero).  A module's parameters and buffers are replaced in
    place, tied ones staying tied; a ``DTensor`` keeps its placements;
    containers are rebuilt."""
    from torch.distributed.tensor import DTensor
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    memo = {}

    def tensor(t):
        if id(t) in memo:
            return memo[id(t)][1]
        if isinstance(t, DTensor):
            out = DTensor.from_local(tensor(t._local_tensor), t.device_mesh,
                                     t.placements, run_check=False,
                                     shape=t.shape, stride=t.stride())
        elif gen is None:
            out = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                      device=device)
        elif t.is_floating_point():
            out = (torch.rand(t.shape, generator=gen) * 0.02).to(
                device=device, dtype=t.dtype)
        else:
            out = torch.zeros(t.shape, dtype=t.dtype, device=device)
        if isinstance(t, torch.nn.Parameter):
            out = torch.nn.Parameter(out, requires_grad=t.requires_grad)
        memo[id(t)] = (t, out)
        return out

    def walk(x):
        if isinstance(x, torch.Tensor):
            return tensor(x)
        if isinstance(x, torch.nn.Module):
            for mod in x.modules():
                for table in (mod._parameters, mod._buffers):
                    for k, v in table.items():
                        if v is not None:
                            table[k] = tensor(v)
            return x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: walk(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(tree)


def measure(fn, args):
    """``fn(*args)`` once under a ``counters.Recorder``: ``(outputs,
    recorder, seconds)``."""
    rec = counters.Recorder(args)
    t0 = time.perf_counter()
    with rec:
        out = fn(*args)
    return out, rec, time.perf_counter() - t0


def memory_of(args, out, rec) -> dict:
    """The reference's ``memory`` entry (GB) of one step run under
    ``rec``."""
    mine = counters.storage_keys(args)
    output = counters.storage_bytes(out)
    return {"argument_gb": counters.storage_bytes(args) / 1e9,
            "output_gb": output / 1e9,
            "temp_gb": rec.peak / 1e9,
            "alias_gb": (output - counters.storage_bytes(out, mine)) / 1e9}


def counts_of(rec) -> dict:
    """The recorder's numbers under the record's keys."""
    coll = counters.collective_bytes(rec)
    return {"flops_per_device": rec.flops,
            "flops_by_op_per_device": rec.flops_by_op(),
            "bytes_per_device": rec.bytes_accessed,
            "bytes_by_op_per_device": rec.bytes_by_op(),
            "collective_bytes_per_device": coll,
            "collective_bytes_corrected": dict(coll),
            "collective_calls_per_device": rec.calls()}


def measure_cell(cfg, shape, mesh, *, device: str = "cuda", **cell) -> dict:
    """One cell's step on this rank of ``mesh`` (over a fake world, or a
    real one whose other ranks run the same) on fake tensors of
    ``device``: ``build_cell``'s ``meta``, the seconds of the build and
    of the step, :func:`counts_of` and ``memory``.  ``cell``: the
    keywords of :func:`build_cell`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    fn, args, meta = build_cell(cfg, shape, mesh, **cell)
    t_build = time.perf_counter() - t0
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = materialize(args, device)
        out, rec, t_step = measure(fn, args)
        mem = memory_of(args, out, rec)
    del out, args
    return {"meta": meta, "lower_s": round(t_build, 2),
            "compile_s": round(t_step, 2), **counts_of(rec), "memory": mem}


def run_cell(arch: str, shape: str, multi_pod: bool, *, remat_policy="full",
             accum=None, fsdp=None, step_mode="gspmd", verbose=True,
             moe_overrides=None, device: str = "cuda"):
    """The record of one cell of the full config ``arch`` on the
    production mesh (module docstring), or the reference's skip."""
    from ..configs import get_config
    from ..core.env import resolve_device
    from .accounting import cell_cost
    from .mesh import PRODUCTION, fake_world, make_production_mesh
    from .shapes import SHAPES, cell_enabled

    cfg = get_config(arch)
    if moe_overrides and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_overrides))
    mesh_name = "multi" if multi_pod else "single"
    if not cell_enabled(cfg, shape):
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": SKIP_REASON}
    resolve_device(device)
    dims, names = PRODUCTION[bool(multi_pod)]
    chips = math.prod(dims)
    with fake_world(chips, like="nccl" if device == "cuda" else "gloo"):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        got = measure_cell(cfg, shape, mesh, device=device,
                           remat_policy=remat_policy, accum=accum,
                           fsdp=fsdp, step_mode=step_mode)
    sc = SHAPES[shape]
    meta = got.pop("meta")
    acct = cell_cost(cfg, dims[names.index("model")], chips, seq=sc.seq,
                     batch=sc.global_batch, kind=sc.kind,
                     accum=meta.get("accum", 1), remat=remat_policy,
                     fsdp=meta["fsdp"])
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "status": "ok", "meta": meta, "remat": remat_policy,
        "device": device, **got,
        "analytic_flops_total": acct.flops_total,
        "analytic_bytes_per_device": acct.bytes_per_device,
        "model_flops": acct.model_flops,
        "tokens": sc.seq * sc.global_batch if sc.kind != "decode"
        else sc.global_batch,
        "kind": sc.kind,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }
    if verbose:
        coll = rec["collective_bytes_per_device"]
        print(f"[{mesh_name}] {arch} x {shape}: compile ok "
              f"({rec['compile_s']}s)  flops/dev="
              f"{rec['flops_per_device']:.3e} "
              f"temp={rec['memory']['temp_gb']:.2f}GB "
              f"coll={coll['total']/1e9:.3f}GB/dev")
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="both")
    p.add_argument("--remat", default="full")
    p.add_argument("--accum", type=int, default=None)
    p.add_argument("--fsdp", type=int, default=None)
    p.add_argument("--out", default="artifacts")
    p.add_argument("--device", default="cuda",
                   help="the fake tensors' device (default cuda; cpu runs "
                   "without a card)")
    p.add_argument("--jobs", type=int, default=1,
                   help="cells run at once, each worker a process of its "
                   "own")
    args = p.parse_args(argv)

    from ..configs import ARCHS
    from .shapes import SHAPES

    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    kw = dict(remat_policy=args.remat, accum=args.accum,
              fsdp=None if args.fsdp is None else bool(args.fsdp),
              device=args.device)
    cells = [(arch, shape, mp, kw) for arch in archs for shape in shapes
             for mp in meshes]
    t0 = time.perf_counter()
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        from . import dryrun as this      # importable by the workers
        # the training cells take longest: they start first
        first = sorted(range(len(cells)), key=lambda i: SHAPES[
            cells[i][1]].kind != "train" if cells[i][1] in SHAPES else True)
        with ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            done = list(pool.map(this.cell_job, [cells[i] for i in first]))
        results = [None] * len(cells)
        for i, rec in zip(first, done):
            results[i] = rec
    else:
        results = [cell_job(c) for c in cells]
    for rec in results:
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    failures = sum(1 for r in results if r["status"] == "failed")
    print(f"dry-run wall: {time.perf_counter() - t0:.1f}s")
    print(f"\ndry-run: {ok} ok, {sk} skipped, {failures} failed "
          f"/ {len(results)} cells")
    return 1 if failures else 0


def cell_job(cell) -> dict:
    """:func:`run_cell` of ``(arch, shape, multi_pod, keywords)``, a
    failure recorded (and its traceback printed) rather than raised."""
    arch, shape, mp, kw = cell
    try:
        return run_cell(arch, shape, mp, **kw)
    except Exception as e:  # noqa: BLE001 — report, keep going
        traceback.print_exc()
        return {"arch": arch, "shape": shape,
                "mesh": "multi" if mp else "single",
                "status": "failed", "error": repr(e)}


if __name__ == "__main__":
    sys.exit(main())
