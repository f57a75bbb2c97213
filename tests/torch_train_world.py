"""One rank of the port's data-parallel training checks on the CPU (gloo),
for ``tests/test_torch_dp_train.py``; not collected by pytest, imports no
jax.

    RANK=k WORLD_SIZE=n REPRO_WORLD_INIT=... \\
        python tests/torch_train_world.py SPEC.json OUTDIR

(``repro_torch.scripts.local_world.spawn`` sets the environment.)  The
spec names the mesh's shape, the inputs (``.npz``: the reference's
weights under their dotted paths, a batch, the all-reduce inputs) and the
cases; every case runs on every rank and writes
``OUTDIR/{case}_{rank}.npz``.  A case's error goes into
``OUTDIR/rank{rank}.json``.
"""
import copy
import json
import os
import sys
import traceback

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.checkpoint.reshard import reshard_restore
from repro_torch.distributed import compression
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import reference_paths
from repro_torch.scripts import local_world
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.state import abstract_state, init_state
from repro_torch.train.step import (make_local_accum_train_step,
                                    make_train_step, make_zero1_local_state)

OC = dict(lr=1e-3, warmup_steps=1, decay_steps=50)
ACCUM = 2


def nested(flat):
    """Dotted paths -> the nested dict ``params_from_jax`` takes."""
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def local_of(t):
    t = t.detach()
    return (t.to_local() if hasattr(t, "to_local") else t).numpy().copy()


def full_of(t):
    t = t.detach()
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()


def params_out(model, prefix="p."):
    return {prefix + n: p.detach().numpy().copy()
            for n, p in model.named_parameters()}


def checksum(model) -> np.ndarray:
    return np.concatenate([p.detach().numpy().reshape(-1)
                           for p in model.parameters()])


def case_allreduce(ctx):
    """``compressed_allreduce`` and ``compressed_psum`` of this rank's row
    of the inputs, every ``quantize_int8`` payload recorded."""
    x = torch.from_numpy(ctx["inputs"]["allreduce_x"][ctx["rank"]].copy())
    seen = []
    real = compression.quantize_int8

    def recording(t):
        q, s = real(t)
        seen.append((q.numpy().copy(), float(s)))
        return q, s
    compression.quantize_int8 = recording
    try:
        y = compression.compressed_allreduce(x, ctx["mesh"], "data")
    finally:
        compression.quantize_int8 = real
    y2 = compression.compressed_psum(x, ctx["mesh"], "data")
    (q_send, s_send), (q_sum, s_sum) = seen
    return {"q_send": q_send, "s_send": np.float32(s_send), "q_sum": q_sum,
            "s_sum": np.float32(s_sum), "y": y.numpy(), "y2": y2.numpy()}


def case_steps(ctx):
    """One step of the single-card, the local-accumulation and the ZeRO-1
    steps from the same weights; ZeRO-1 on to step 3 with a checkpoint at
    step 2 restored and replayed; the ZeRO-1 state after step 1 saved for
    the reference; 5 int8 steps."""
    cfg, mesh, batch = ctx["cfg"], ctx["mesh"], ctx["batch"]
    oc = OptimizerConfig(**OC)
    base = ctx["model"]
    out = {}
    single = copy.deepcopy(base)
    s1, m1 = make_train_step(cfg, oc, accum_steps=ACCUM)(init_state(single),
                                                          batch)
    out.update(params_out(s1.params, "single.p."),
               **{"single.loss": float(m1["loss"]),
                  "single.grad_norm": float(m1["grad_norm"])})

    local = make_local_accum_train_step(cfg, oc, mesh, accum_steps=ACCUM)
    sl, ml = local(init_state(copy.deepcopy(base)), batch)
    out.update(params_out(sl.params, "local.p."),
               **{f"local.mu.{k}": v.numpy().copy() for k, v in sl.mu.items()},
               **{f"local.nu.{k}": v.numpy().copy() for k, v in sl.nu.items()},
               **{"local.loss": float(ml["loss"]),
                  "local.grad_norm": float(ml["grad_norm"])})

    n = ctx["world"]
    zstep = make_local_accum_train_step(cfg, oc, mesh, accum_steps=ACCUM,
                                        zero1=True)
    sz = make_zero1_local_state(copy.deepcopy(base), n, mesh=mesh)
    sz, mz = zstep(sz, batch)
    out.update(params_out(sz.params, "zero1.p."),
               **{f"zero1.mu.{k}": full_of(v) for k, v in sz.mu.items()},
               **{f"zero1.nu.{k}": full_of(v) for k, v in sz.nu.items()},
               **{f"zero1.mu_local.{k}": local_of(v)
                  for k, v in sz.mu.items()},
               **{"zero1.loss": float(mz["loss"]),
                  "zero1.grad_norm": float(mz["grad_norm"])})
    ckpt_io.save(sz, ctx["spec"]["zero1_port_dir"], 1)
    sz, _ = zstep(sz, batch)
    ckpt = os.path.join(ctx["out"], "zero1_replay")
    ckpt_io.save(sz, ckpt, 2)
    sz, _ = zstep(sz, batch)
    again = make_zero1_local_state(copy.deepcopy(base), n, mesh=mesh)
    again, at = ckpt_io.restore(again, ckpt)
    again, _ = zstep(again, batch)
    out["zero1.replayed_step"] = at
    out["zero1.step3"] = checksum(sz.params)
    out["zero1.replayed"] = checksum(again.params)
    out["zero1.replayed_mu"] = np.concatenate(
        [local_of(v).reshape(-1) for v in again.mu.values()])
    out["zero1.step3_mu"] = np.concatenate(
        [local_of(v).reshape(-1) for v in sz.mu.values()])

    qstep = make_local_accum_train_step(cfg, oc, mesh, accum_steps=ACCUM,
                                        int8_allreduce=True)
    sq = init_state(copy.deepcopy(base))
    losses = []
    for _ in range(5):
        sq, mq = qstep(sq, batch)
        losses.append(float(mq["loss"]))
    out["int8.losses"] = np.array(losses)
    out["int8.checksum"] = checksum(sq.params)
    out["local.checksum"] = checksum(sl.params)
    return out


def case_zero1_from_reference(ctx):
    """The reference's ZeRO-1 checkpoint restored into this rank's
    DTensor moments (its rows) and the replicated params."""
    st = make_zero1_local_state(copy.deepcopy(ctx["model"]), ctx["world"],
                                mesh=ctx["mesh"])
    st, at = ckpt_io.restore(st, ctx["spec"]["zero1_ref_dir"])
    out = params_out(st.params)
    out.update({f"mu.{k}": local_of(v) for k, v in st.mu.items()})
    out.update({f"nu.{k}": local_of(v) for k, v in st.nu.items()})
    out["step"] = np.array([int(st.step), at])
    return out


def case_reshard(ctx):
    """The reference's (4, 2)-mesh checkpoint restored with ``fsdp=True``
    onto a mesh of the spec's ``reshard_mesh`` over this world: each leaf's local slice, and whether its
    ``full_tensor()`` equals the saved leaf bitwise."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg, d = ctx["cfg"], ctx["spec"]["reshard_dir"]
    mesh = init_device_mesh("cpu", tuple(ctx["spec"]["reshard_mesh"]),
                            mesh_dim_names=("data", "model"))
    state, at = reshard_restore(abstract_state(cfg), d, cfg, mesh,
                                fsdp=True)
    paths = reference_paths(state.params)
    out, whole = {"step": np.array([int(state.step), at])}, []
    trees = [("1", "p", dict(state.params.named_parameters())),
             ("2", "mu", state.mu), ("3", "nu", state.nu)]
    for idx, tag, tree in trees:
        for name, t in tree.items():
            path, j = paths[name]
            saved = np.load(os.path.join(d, f"step_{at:08d}",
                                         f"{idx}.{path}.npy"))
            saved = saved if j is None else saved[j]
            out[f"{tag}.{name}"] = local_of(t)
            whole.append(bool(np.array_equal(full_of(t), saved)))
            out[f"placements.{tag}.{name}"] = np.array(
                [str(p) for p in t.placements])
    out["is_dtensor"] = np.array([hasattr(p, "to_local")
                                  for p in state.params.parameters()])
    out["full_equal"] = np.array(whole)
    return out


CASES = {"allreduce": case_allreduce, "steps": case_steps,
         "zero1_from_reference": case_zero1_from_reference,
         "reshard": case_reshard}


def main(spec_path, out_dir):
    with open(spec_path) as f:
        spec = json.load(f)
    torch.manual_seed(0)
    mesh, rank, world = local_world.join("gloo", "cpu", spec["mesh"],
                                         ("data", "model"))
    inputs = dict(np.load(spec["inputs"]))
    cfg = configs.reduced_config(spec["arch"])
    weights = {k[2:]: v for k, v in inputs.items() if k.startswith("w.")}
    ctx = {"spec": spec, "mesh": mesh, "rank": rank, "world": world,
           "cfg": cfg, "out": out_dir, "inputs": inputs,
           "model": params_from_jax(nested(weights), cfg, device="cpu",
                                    dtype=torch.float32),
           "batch": {"tokens": torch.from_numpy(inputs["tokens"]),
                     "labels": torch.from_numpy(inputs["labels"])}}
    errors = {}
    try:
        for name in spec["cases"]:
            try:
                got = CASES[name](ctx)
            except Exception:           # reported per case to the test
                errors[name] = traceback.format_exc()
                continue
            np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), **got)
    finally:
        local_world.leave()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"errors": errors}, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
