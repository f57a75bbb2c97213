"""One rank of the port's FSDP checks on the CPU (gloo), for
``tests/test_torch_fsdp.py``; not collected by pytest, imports no jax.

    RANK=k WORLD_SIZE=n REPRO_WORLD_INIT=... \\
        python tests/torch_fsdp_world.py SPEC.json OUTDIR

(``repro_torch.scripts.local_world.spawn`` sets the environment.)  The
spec names the mesh's shape (``("data", "model")``), the inputs (``.npz``:
the reference's f32 weights under ``w.{arch}.{dotted path}`` and each
arch's batch under ``b.{arch}.{key}``) and the cases; every case runs on
every rank and writes ``OUTDIR/{case}_{rank}.npz`` (a case's error goes
into ``OUTDIR/rank{rank}.json``).  A bf16 value is written as its f32
value; dtypes go under ``dtype.`` keys.
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
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.launch.dryrun import build_cell
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import loss_fn, params_from_jax
from repro_torch.scripts import local_world
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.state import abstract_state, init_state
from repro_torch.train.step import make_train_step

F32, BF16 = torch.float32, torch.bfloat16
OC = dict(lr=1e-3, warmup_steps=0, decay_steps=50)
ACCUM, STEPS = 2, 2
SERVE_BATCH, SERVE_SEQ, MAX_SEQ, DECODE_STEPS = 2, 8, 16, 3
CKPT_ARCH = "mixtral-8x22b"
LOCAL_OC = dict(lr=1e-3, warmup_steps=1, decay_steps=50)
LOCAL_STEPS = 2


def nested(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def weights_of(inputs, arch):
    head = f"w.{arch}."
    return nested({k[len(head):]: v for k, v in inputs.items()
                   if k.startswith(head)})


def batch_of(inputs, arch):
    head = f"b.{arch}."
    return {k[len(head):]: torch.from_numpy(np.array(v))
            for k, v in inputs.items() if k.startswith(head)}


def base_archs(ctx):
    return [a for a in ctx["spec"]["archs"] if "@" not in a]


def state_dtype(arch):
    return BF16 if arch in configs.BF16_STATE_ARCHS else None


def f32(t):
    if hasattr(t, "to_local"):
        t = ckpt_io._whole(t)
    return t.detach().to(F32).numpy().copy()


def local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def sharded(ctx, arch, dtype=F32):
    cfg = configs.reduced_config(arch)
    model = params_from_jax(weights_of(ctx["inputs"], arch), cfg,
                            device="cpu", dtype=dtype, tp=ctx["tp"])
    return cfg, model


def whole_out(model, tree, prefix, out):
    """Each leaf of ``tree`` (params or moments by name) whole, as f32."""
    for name, t in tree.items():
        if not hasattr(t, "to_local"):
            t = tpar.whole_of(model, name, t.detach())
        out[prefix + name] = f32(t)


def case_steps(ctx):
    """Every arch: ``STEPS`` steps of ``make_train_step(..., mesh)`` at
    ``fsdp=True`` from the reference's weights (bf16 state for
    ``BF16_STATE_ARCHS``): losses, gradient norms, the moments' dtypes
    after each step, the whole moments after the first and the whole
    params and moments after the last, each
    rank's local shapes; ``gather_model`` of a freshly sharded model
    against the whole one; on rank 0, the single-card step's run on the
    same weights and batch."""
    out = {}
    oc = OptimizerConfig(**OC)
    for run in ctx["spec"]["archs"]:
        arch = run.split("@")[0]        # "arch@seq": another batch
        cfg, model = sharded(ctx, arch)
        whole = copy.deepcopy(model)
        tpar.shard_model(model, cfg, ctx["mesh"], fsdp=True)
        for name, p in model.named_parameters():
            out[f"{run}.shape.p.{name}"] = np.array(p.shape)
        back = tpar.gather_model(copy.deepcopy(model))
        out[f"{run}.gather_equal"] = np.array(all(
            torch.equal(a, b) for a, b in zip(back.parameters(),
                                              whole.parameters())))
        state = init_state(model, dtype=state_dtype(arch),
                           mesh=ctx["mesh"])
        for name, m in state.mu.items():
            out[f"{run}.shape.m.{name}"] = np.array(local(m).shape)
        step = make_train_step(cfg, oc, accum_steps=ACCUM, mesh=ctx["mesh"])
        batch = batch_of(ctx["inputs"], run)
        losses, norms, dtypes = [], [], []
        for i in range(STEPS):
            state, m = step(state, batch)
            if i == 0:              # the first step's moments: its gradient
                whole_out(model, state.mu, f"{run}.mu1.", out)
                whole_out(model, state.nu, f"{run}.nu1.", out)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            dtypes.append(sorted({str(local(v).dtype)
                                  for v in list(state.mu.values())
                                  + list(state.nu.values())}))
        out[f"{run}.losses"] = np.array(losses)
        out[f"{run}.grad_norms"] = np.array(norms)
        out[f"{run}.moment_dtypes"] = np.array(
            [",".join(d) for d in dtypes])
        out[f"{run}.param_dtype"] = np.array(
            str(next(model.parameters()).dtype))
        whole_out(model, dict(state.params.named_parameters()),
                  f"{run}.p.", out)
        whole_out(model, state.mu, f"{run}.mu.", out)
        whole_out(model, state.nu, f"{run}.nu.", out)
        if ctx["rank"] == 0:        # the single-card step on the same data
            one = init_state(whole, dtype=state_dtype(arch))
            single = make_train_step(cfg, oc, accum_steps=ACCUM)
            for i in range(STEPS):
                one, m = single(one, batch)
                out[f"{run}.single.loss{i}"] = np.float32(m["loss"])
                if i == 0:
                    for tag, tree in (("mu1", one.mu), ("nu1", one.nu)):
                        out.update({f"{run}.single.{tag}.{n}": f32(t)
                                    for n, t in tree.items()})
            for name, p in one.params.named_parameters():
                out[f"{run}.single.p.{name}"] = f32(p)
            for tag, tree in (("mu", one.mu), ("nu", one.nu)):
                out.update({f"{run}.single.{tag}.{n}": f32(t)
                            for n, t in tree.items()})
    return out


def _whole_leaf_shapes(model):
    """The shapes of the layers' data-sharded leaves, whole."""
    from repro_torch.distributed.sharding import whole_shape
    return {tuple(whole_shape(model, n)) for n in model.data_dims
            if n.startswith("layers.")}


def case_saved(ctx):
    """What outlives a layer in the reduced mixtral's FSDP forward under
    ``remat="full"``, the collector off: the gathered layer leaves still
    alive when the forward ends (none should be), the shapes of the saved
    tensors that have a layer leaf's whole shape (none should), and the
    saved bytes beside those of the same model unsharded."""
    import gc
    import weakref
    from repro_torch.distributed import fsdp
    cfg, model = sharded(ctx, CKPT_ARCH)
    whole = copy.deepcopy(model)
    tpar.shard_model(model, cfg, ctx["mesh"], fsdp=True)
    batch = {k: v[:2] for k, v in batch_of(ctx["inputs"],
                                           CKPT_ARCH).items()}
    out = {}
    real, gathered = fsdp.gather_leaf, []

    def recording(piece, dim, dg):
        t = real(piece, dim, dg)
        if piece.dim() > 1 and piece.shape[0] != model.embed.shape[0]:
            gathered.append(weakref.ref(t))       # a layer's leaf
        return t
    for tag, m in (("fsdp", model), ("whole", whole)):
        seen = []

        def pack(t):
            seen.append((tuple(t.shape), t.numel() * t.element_size()))
            return t
        gc.disable()
        fsdp.gather_leaf = recording
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = loss_fn(m, batch, cfg, "full")
            out[f"{tag}.gathered"] = np.int64(len(gathered))
            out[f"{tag}.alive"] = np.int64(sum(r() is not None
                                               for r in gathered))
        finally:
            fsdp.gather_leaf = real
            gc.enable()
        loss.backward()
        bad = _whole_leaf_shapes(model) if tag == "fsdp" else set()
        out[f"{tag}.whole_leaves"] = np.array(
            [str(s) for s, _ in seen if s in bad])
        out[f"{tag}.saved_bytes"] = np.int64(sum(b for _, b in seen))
    return out


def case_serve(ctx):
    """Every arch: prefill and ``DECODE_STEPS`` greedy decode steps at
    ``fsdp=True`` with the batch split over the data axes, and the same
    steps on the unsharded model: tokens and logits of both."""
    out = {}
    for arch in base_archs(ctx):
        cfg, model = sharded(ctx, arch, dtype=BF16)
        batch = batch_of(ctx["inputs"], arch)
        prompt = {k: v[:SERVE_BATCH, :SERVE_SEQ] for k, v in batch.items()
                  if k in ("tokens", "frames")}
        if "image_embeds" in batch:
            prompt["image_embeds"] = batch["image_embeds"][:SERVE_BATCH]
        runs = (("whole", copy.deepcopy(model), None),
                ("fsdp", tpar.shard_model(model, cfg, ctx["mesh"],
                                          fsdp=True), ctx["mesh"]))
        for tag, m, mesh in runs:
            prefill = make_prefill_step(cfg, MAX_SEQ, tp=ctx["tp"],
                                        mesh=mesh)
            decode = make_decode_step(cfg, MAX_SEQ, tp=ctx["tp"], mesh=mesh)
            lg, caches = prefill(m, prompt)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            toks, logits = [tok], [lg.float().numpy()]
            for i in range(DECODE_STEPS):
                pos = torch.full((SERVE_BATCH,), SERVE_SEQ + i,
                                 dtype=torch.int32)
                tok, lg, caches = decode(m, caches, {"token": tok,
                                                     "pos": pos})
                toks.append(tok)
                logits.append(lg.float().numpy())
            out[f"{arch}.{tag}.tokens"] = torch.stack(toks).numpy()
            out[f"{arch}.{tag}.logits"] = np.stack(logits)
            out[f"{arch}.{tag}.cache_rows"] = np.array(
                [next(iter(c.values())).shape[0] for c in caches])
    return out


def case_ckpt(ctx):
    """The reference's ``fsdp=True`` checkpoint of the reduced mixtral (a
    bf16 state, f32 moments) through ``reshard_restore(..., fsdp=True)``
    and ``shard_model``: each rank's pieces; one step on it; the stepped
    state saved for the reference to read, and its whole values."""
    spec, mesh, tp = ctx["spec"], ctx["mesh"], ctx["tp"]
    cfg = configs.reduced_config(CKPT_ARCH)
    st, at = reshard_restore(abstract_state(cfg, tp=tp, dtype=BF16),
                             spec["ckpt_ref_dir"], cfg, mesh, fsdp=True)
    model = tpar.shard_model(st.params, cfg, mesh, fsdp=True)
    out = {"step": np.array([int(st.step), at])}
    for name, p in model.named_parameters():
        out[f"piece.p.{name}"] = f32(p)
        out[f"dtype.p.{name}"] = np.array(str(p.dtype))
    for tag, tree in (("mu", st.mu), ("nu", st.nu)):
        for name, m in tree.items():
            out[f"piece.{tag}.{name}"] = f32(local(m))
            out[f"dtype.{tag}.{name}"] = np.array(str(local(m).dtype))
    step = make_train_step(cfg, OptimizerConfig(**OC), accum_steps=ACCUM,
                           mesh=mesh)
    st, m = step(st, batch_of(ctx["inputs"], CKPT_ARCH))
    out["loss"] = np.float32(m["loss"])
    whole_out(model, dict(model.named_parameters()), "p.", out)
    whole_out(model, st.mu, "mu.", out)
    whole_out(model, st.nu, "nu.", out)
    for name, p in model.named_parameters():
        w = tpar.whole_of(model, name, p.detach())
        out[f"bits.p.{name}"] = w.view(torch.int16).numpy().copy()
    ckpt_io.save(st, spec["ckpt_port_dir"], int(st.step))
    return out


def case_launch(ctx):
    """``build_cell`` of every arch and shape on the ``meta`` device:
    its ``fsdp``, state dtype, ``accum`` and the shapes of its batch."""
    out = {}
    for arch in base_archs(ctx):
        cfg = configs.reduced_config(arch)
        for shape in SHAPES:
            fn, args, meta = build_cell(cfg, shape, ctx["mesh"])
            key = f"{arch}.{shape}"
            out[f"{key}.fsdp"] = np.array(meta["fsdp"])
            out[f"{key}.accum"] = np.int64(meta.get("accum", 1))
            first = args[0].params if hasattr(args[0], "params") else args[0]
            out[f"{key}.dtype"] = np.array(
                str(first.get_parameter("layers.0.norm1").dtype))
            for k, v in args[-1].items():
                out[f"{key}.batch.{k}"] = np.array(list(v.shape) + [
                    str(v.dtype)])
    return out


def case_card(ctx):
    """On the card: the data axis's region, ``fsdp.gather_leaf``, against
    ``torch.cat`` of every rank's piece, and its backward against the sum
    of every rank's gradient (in f32, in rank order) cut to this rank's
    piece, on CUDA tensors over gloo; bf16 and f32, dims 0 and 1."""
    from repro_torch.distributed import fsdp
    dev = torch.device("cuda", 0)
    dg = fsdp.data_group(ctx["mesh"])
    n, k = dg.size, dg.rank
    out = {}
    for dtype in (F32, BF16):
        for dim, shape in ((0, (6, 5)), (1, (3, 8, 4))):
            g = torch.Generator().manual_seed(7)
            pieces = [torch.randn(shape, generator=g).to(dtype)
                      for _ in range(n)]
            full = list(shape)
            full[dim] *= n
            grads = [torch.randn(full, generator=g).to(dtype)
                     for _ in range(n)]
            piece = pieces[k].to(dev).requires_grad_(True)
            whole = fsdp.gather_leaf(piece, dim, dg)
            whole.backward(grads[k].to(dev))
            total = grads[0].float()
            for j in range(1, n):
                total = total + grads[j].float()
            want = total.chunk(n, dim=dim)[k].to(dtype)
            key = f"{str(dtype)[6:]}.dim{dim}"
            out[f"{key}.gather"] = np.array(
                whole.is_cuda and torch.equal(whole.detach().cpu(),
                                              torch.cat(pieces, dim=dim)))
            out[f"{key}.reduce_scatter"] = np.array(
                piece.grad.is_cuda and torch.equal(piece.grad.cpu(), want))
    return out


def _local_run(ctx, arch, mode, fsdp, dtype):
    """``LOCAL_STEPS`` local-accumulation steps of ``mode`` from the
    reference's weights on a model ``shard_model(..., fsdp=fsdp)``
    sharded: ``(model, state, metrics of each step, whole state after the
    first step)``."""
    from repro_torch.distributed.sharding import dp_axes, mesh_axes
    from repro_torch.train.state import cast_model
    from repro_torch.train.step import (make_local_accum_train_step,
                                        make_zero1_local_state)
    cfg, model = sharded(ctx, arch)
    if dtype is not None:
        cast_model(model, dtype)
    mesh = ctx["mesh"]
    tpar.shard_model(model, cfg, mesh, fsdp=fsdp)
    zero1 = mode == "local_zero1"
    axes = mesh_axes(mesh)
    state = make_zero1_local_state(model, axes["data"], ctx["tp"],
                                   mesh=mesh) if zero1 else init_state(model)
    step = make_local_accum_train_step(
        cfg, OptimizerConfig(**LOCAL_OC), mesh, accum_steps=ACCUM,
        int8_allreduce=mode.endswith("int8"), zero1=zero1,
        batch_axes=("data",) if zero1 else dp_axes(axes))
    batch = batch_of(ctx["inputs"], arch)
    metrics, first = [], {}
    for i in range(LOCAL_STEPS):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            whole_out(model, dict(model.named_parameters()), "p.", first)
            for tag, tree in (("mu", state.mu), ("nu", state.nu)):
                if zero1:
                    first.update({f"{tag}.{k}": f32(v)
                                  for k, v in tree.items()})
                else:
                    whole_out(model, tree, f"{tag}.", first)
    return model, state, metrics, first


def case_local(ctx):
    """The local-accumulation step of each mode of ``local_modes`` at
    ``fsdp=True`` (f32, and the bf16 state of ``BF16_STATE_ARCHS`` in
    ``local_accum``) beside the same step at ``fsdp=False`` from the same
    weights: each step's loss and gradient norm, the whole state after
    the first step (``fsdp=True``), whether the pieces of the
    ``fsdp=True`` run's parameters and moments after the last step are
    bitwise those ``shard_model`` keeps of the ``fsdp=False`` run's, and
    the elements of both runs' parameters on this rank."""
    from repro_torch.distributed import fsdp
    out = {}
    dg = fsdp.data_group(ctx["mesh"])
    for arch in base_archs(ctx):
        for mode in ctx["spec"]["local_modes"]:
            dtypes = [None]
            if mode == "local_accum" and arch in configs.BF16_STATE_ARCHS:
                dtypes.append(BF16)
            for dtype in dtypes:
                key = f"{arch}.{mode}.{'bf16' if dtype else 'f32'}"
                m1, s1, met1, first = _local_run(ctx, arch, mode, True,
                                                 dtype)
                m0, s0, met0, _ = _local_run(ctx, arch, mode, False, dtype)
                out.update({f"{key}.first.{k}": v for k, v in first.items()})
                out[f"{key}.metrics"] = np.array(met1)
                out[f"{key}.metrics_whole"] = np.array(met0)
                dims = m1.data_dims
                assert dims, "fsdp=True split no leaf over the data axes"

                def cut(name, t):
                    d = dims.get(name)
                    return t if d is None else t.chunk(dg.size, d)[dg.rank]
                same = []
                for (name, p1), p0 in zip(m1.named_parameters(),
                                          m0.parameters()):
                    same.append(torch.equal(p1, cut(name, p0)))
                for t1, t0 in ((s1.mu, s0.mu), (s1.nu, s0.nu)):
                    for name, v in t1.items():
                        w = t0[name]
                        same.append(torch.equal(local(v), local(w))
                                    if mode == "local_zero1"
                                    else torch.equal(v, cut(name, w)))
                out[f"{key}.bitwise"] = np.array(all(same))
                out[f"{key}.numel"] = np.array(
                    [sum(p.numel() for p in m.parameters())
                     for m in (m1, m0)])
    return out


CASES = {"steps": case_steps, "saved": case_saved, "serve": case_serve,
         "ckpt": case_ckpt, "launch": case_launch, "card": case_card,
         "local": case_local}


def main(spec_path, out_dir):
    with open(spec_path) as f:
        spec = json.load(f)
    torch.manual_seed(0)
    torch.set_num_threads(1)        # the ranks share the host's cores
    device = spec.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)          # every rank on the one card
    mesh, rank, world = local_world.join("gloo", device, spec["mesh"],
                                         ("data", "model"))
    ctx = {"spec": spec, "mesh": mesh, "rank": rank, "world": world,
           "tp": spec["mesh"][1],
           "inputs": dict(np.load(spec["inputs"])) if spec.get("inputs")
           else {}}
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
