"""One rank of the port's tensor-parallel checks on the CPU (gloo), for
``tests/test_torch_tp.py`` and ``tests/test_torch_tp_train.py``; not
collected by pytest, imports no jax.

    RANK=k WORLD_SIZE=n REPRO_WORLD_INIT=... \\
        python tests/torch_tp_world.py SPEC.json OUTDIR

(``repro_torch.scripts.local_world.spawn`` sets the environment.)  The
spec names the mesh's shape (``("data", "model")``), the inputs (``.npz``:
the reference's weights under ``w.{arch}.{dotted path}``, a step batch,
injected gradients) and the cases; every case runs on every rank and
writes ``OUTDIR/{case}_{rank}.npz``.  A case's error goes into
``OUTDIR/rank{rank}.json``.  The test files import the batch helpers.
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
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.models import loss_fn, params_from_jax
from repro_torch.models.transformer import init_caches
from repro_torch.scripts import local_world
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.state import abstract_state, init_state
from repro_torch.train.step import (int8_reduce_leaf_,
                                    make_local_accum_train_step,
                                    make_zero1_local_state, reference_leaves)

F32 = torch.float32
BATCH, SEQ, DECODE_STEPS = 2, 8, 3
MAX_SEQ = 36            # 2, 3 and 4 divide it: the caches split over ranks
OC = dict(lr=1e-3, warmup_steps=1, decay_steps=50)
ACCUM = 2
STEP_ARCH = "phi4-mini-3.8b"


def kind_batch(cfg, b=BATCH, s=SEQ, seed=5):
    """A numpy batch for any kind: tokens or frames, labels, image
    embeddings for an ``xattn`` arch (``tests/torch_train_ref.py``'s)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.embed_stub:
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        out["image_embeds"] = rng.normal(
            size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def decode_tokens(cfg, seed=6):
    """Teacher-forced decode tokens, ``(DECODE_STEPS, BATCH)``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size,
                        (DECODE_STEPS, BATCH)).astype(np.int32)


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


def weights_of(inputs, arch):
    head = f"w.{arch}."
    return nested({k[len(head):]: v for k, v in inputs.items()
                   if k.startswith(head)})


def whole_np(model, name, t):
    lay = getattr(model, "layouts", {}).get(name)
    return tpar.whole(t.detach(), lay, getattr(model, "mg", None)).numpy() \
        .copy()


def torch_batch(batch, bf16=False):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.to(torch.bfloat16) if bf16 and t.is_floating_point() else t
    return out


def case_forward(ctx):
    """For each arch: loss and whole gradients, prefill logits and
    ``DECODE_STEPS`` teacher-forced decode logits through the serve steps;
    each rank's piece sizes of the parameters and caches."""
    out = {}
    tp = ctx["tp"]
    for arch in ctx["spec"]["archs"]:
        cfg = configs.reduced_config(arch)
        model = params_from_jax(weights_of(ctx["inputs"], arch), cfg,
                                device="cpu", dtype=F32, tp=tp)
        tpar.shard_model(model, cfg, ctx["mesh"])
        for name, p in model.named_parameters():
            out[f"{arch}.numel.{name}"] = np.int64(p.numel())
        batch = kind_batch(cfg)
        loss = loss_fn(model, torch_batch(batch), cfg)
        loss.backward()
        out[f"{arch}.loss"] = np.float32(loss.detach())
        for name, p in model.named_parameters():
            out[f"{arch}.g.{name}"] = whole_np(model, name, p.grad)
        model.zero_grad(set_to_none=True)
        prompt = {k: v for k, v in batch.items() if k != "labels"}
        prefill = make_prefill_step(cfg, MAX_SEQ, tp=tp)
        decode = make_decode_step(cfg, MAX_SEQ, tp=tp)
        lg, caches = prefill(model, torch_batch(prompt, bf16=True))
        out[f"{arch}.logits0"] = lg.float().numpy()
        for i, tok in enumerate(decode_tokens(cfg)):
            pos = torch.full((BATCH,), SEQ + i, dtype=torch.int32)
            nxt, lg, caches = decode(model, caches, {
                "token": torch.from_numpy(tok), "pos": pos})
            out[f"{arch}.logits{i + 1}"] = lg.float().numpy()
            out[f"{arch}.next{i + 1}"] = nxt.numpy()
        for layer, c in enumerate(caches):
            for k, t in c.items():
                out[f"{arch}.cache.{layer}.{k}"] = np.array(t.shape)
        fresh = init_caches(cfg, BATCH, MAX_SEQ, device="cpu", tp=tp)
        for layer, (c, f) in enumerate(zip(caches, fresh)):
            for k in c:
                assert c[k].shape == f[k].shape, (arch, layer, k)
    return out


def _step_model(ctx, tp):
    cfg = configs.reduced_config(STEP_ARCH)
    model = params_from_jax(weights_of(ctx["inputs"], STEP_ARCH), cfg,
                            device="cpu", dtype=F32, tp=tp)
    return cfg, tpar.shard_model(model, cfg, ctx["mesh"])


def _params_out(model, prefix):
    return {prefix + n: whole_np(model, n, p)
            for n, p in model.named_parameters()}


def case_steps(ctx):
    """One local-accumulation step (f32) and one ZeRO-1 step on the
    ``("data", "model")`` mesh from the same weights: whole params,
    moments, loss and gradient norm; then 5 int8 steps' losses."""
    tp = ctx["tp"]
    oc = OptimizerConfig(**OC)
    batch = torch_batch({k: ctx["inputs"][k] for k in ("tokens", "labels")})
    out = {}
    cfg, model = _step_model(ctx, tp)
    step = make_local_accum_train_step(cfg, oc, ctx["mesh"],
                                       accum_steps=ACCUM)
    st, m = step(init_state(model), batch)
    out.update(_params_out(st.params, "local.p."))
    for tag, tree in (("mu", st.mu), ("nu", st.nu)):
        out.update({f"local.{tag}.{n}": whole_np(st.params, n, t)
                    for n, t in tree.items()})
    out["local.loss"] = np.float32(m["loss"])
    out["local.grad_norm"] = np.float32(m["grad_norm"])
    out["local.numel"] = np.int64(sum(p.numel()
                                      for p in st.params.parameters()))

    cfg, model = _step_model(ctx, tp)
    zstep = make_local_accum_train_step(cfg, oc, ctx["mesh"],
                                        accum_steps=ACCUM, zero1=True)
    sz = make_zero1_local_state(model, ctx["n_dp"], tp, mesh=ctx["mesh"])
    sz, mz = zstep(sz, batch)
    out.update(_params_out(sz.params, "zero1.p."))
    for tag, tree in (("mu", sz.mu), ("nu", sz.nu)):
        for k, v in tree.items():
            out[f"zero1.{tag}.{k}"] = ckpt_io._whole(v).numpy().copy()
            out[f"zero1.{tag}_local.{k}"] = v.to_local().numpy().copy()
    out["zero1.loss"] = np.float32(mz["loss"])
    out["zero1.grad_norm"] = np.float32(mz["grad_norm"])

    cfg, model = _step_model(ctx, tp)
    qstep = make_local_accum_train_step(cfg, oc, ctx["mesh"],
                                        accum_steps=ACCUM,
                                        int8_allreduce=True)
    sq, losses = init_state(model), []
    for _ in range(5):
        sq, mq = qstep(sq, batch)
        losses.append(float(mq["loss"]))
    out["int8.losses"] = np.array(losses)
    return out


def case_payloads(ctx):
    """The step's int8 reduction of injected gradients (``g.{path}``, one
    row a data rank): each ``quantize_int8`` payload, and the reduced
    whole leaf."""
    tp = ctx["tp"]
    cfg, model = _step_model(ctx, tp)
    data = ctx["mesh"].get_local_rank("data")
    mg, lay = model.mg, model.layouts
    leaves = reference_leaves(model)
    out, seen = {}, []
    real = compression.quantize_int8

    def recording(t):
        q, s = real(t)
        seen.append((q.numpy().copy(), np.float32(s)))
        return q, s
    group = ctx["mesh"].get_group("data")
    for path in ctx["spec"]["payload_leaves"]:
        g = ctx["inputs"][f"g.{path}"][data]
        members = leaves[path]
        for j, (name, p) in enumerate(members):
            whole = torch.from_numpy(np.array(g[j] if path.startswith("seg")
                                              else g))
            p.grad = tpar.take(whole, lay.get(name), mg.rank,
                               mg.size).contiguous().clone()
        seen.clear()
        compression.quantize_int8 = recording
        try:
            int8_reduce_leaf_(model, members, [group], 1.0)
        finally:
            compression.quantize_int8 = real
        (q1, s1), (q2, s2) = seen
        out.update({f"{path}.q_send": q1, f"{path}.s_send": s1,
                    f"{path}.q_sum": q2, f"{path}.s_sum": s2})
        out[f"{path}.y"] = np.stack([whole_np(model, n, p.grad)
                                     for n, p in members])
    return out


def case_ckpt(ctx):
    """The reference's tp=2 checkpoint restored into this rank's pieces;
    saved again from them (every rank takes part) for the reference to
    read; restored through ``reshard_restore`` + ``shard_model`` into a
    model whose loss equals the restored one's."""
    tp = ctx["tp"]
    spec = ctx["spec"]
    cfg = configs.reduced_config(STEP_ARCH)
    model = tpar.shard_model(copy.deepcopy(abstract_state(cfg, tp=tp).params)
                             .to_empty(device="cpu"), cfg, ctx["mesh"])
    state, at = ckpt_io.restore(init_state(model), spec["ckpt_ref_dir"])
    out = {"step": np.array([int(state.step), at])}
    for n, p in state.params.named_parameters():
        out[f"p.{n}"] = p.detach().numpy().copy()
    for tag, tree in (("mu", state.mu), ("nu", state.nu)):
        out.update({f"{tag}.{n}": t.numpy().copy() for n, t in tree.items()})
    ckpt_io.save(state, spec["ckpt_port_dir"], at)
    batch = torch_batch({k: ctx["inputs"][k] for k in ("tokens", "labels")})
    with torch.no_grad():
        out["loss"] = np.float32(loss_fn(state.params, batch, cfg))
        st2, _ = reshard_restore(abstract_state(cfg, tp=tp),
                                 spec["ckpt_ref_dir"], cfg, ctx["mesh"],
                                 fsdp=False)
        m2 = tpar.shard_model(st2.params, cfg, ctx["mesh"])
        out["reshard_loss"] = np.float32(loss_fn(m2, batch, cfg))
        out["reshard_equal"] = np.array([
            torch.equal(a, b) for a, b in zip(m2.parameters(),
                                              state.params.parameters())])
    return out


def case_zero1_fault(ctx):
    """ZeRO-1 where the reference's moment layout outgrows the gradient
    shard: the step's ``ValueError``."""
    tp = ctx["tp"]
    cfg, model = _step_model(ctx, tp)
    batch = torch_batch({k: ctx["inputs"][k][:6] for k in ("tokens",
                                                           "labels")})
    step = make_local_accum_train_step(cfg, OptimizerConfig(**OC),
                                       ctx["mesh"], zero1=True)
    state = make_zero1_local_state(model, ctx["n_dp"], tp, mesh=ctx["mesh"])
    try:
        step(state, batch)
    except ValueError as e:
        return {"error": np.array(str(e))}
    return {"error": np.array("")}


def case_card(ctx):
    """On the card: the reduced phi4-mini from ``init_params(cfg, 0,
    tp)``, sharded, against the unsharded run of the same parameters:
    losses, prefill and decode logits."""
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    tp, dev = ctx["tp"], mesh_device(ctx["mesh"])
    # the unsharded run without cuBLAS's bf16 reduced-precision reduction:
    # the sharded one sums its partial products in f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = configs.reduced_config(STEP_ARCH)
    base = init_params(cfg, 0, tp=tp, device=dev, dtype=F32)
    batch = {k: v.to(dev) for k, v in torch_batch(kind_batch(cfg)).items()}
    prompt = {"tokens": batch["tokens"]}
    out = {}
    for tag, model in (("whole", copy.deepcopy(base)),
                       ("sharded", tpar.shard_model(base, cfg, ctx["mesh"]))):
        with torch.no_grad():
            out[f"{tag}.loss"] = np.float32(float(loss_fn(model, batch,
                                                          cfg)))
        lg, caches = make_prefill_step(cfg, MAX_SEQ, tp=tp)(model, prompt)
        logits = [lg.float().cpu().numpy()]
        decode = make_decode_step(cfg, MAX_SEQ, tp=tp)
        for i, tok in enumerate(decode_tokens(cfg)):
            pos = torch.full((BATCH,), SEQ + i, dtype=torch.int32, device=dev)
            _, lg, caches = decode(model, caches, {
                "token": torch.from_numpy(tok).to(dev), "pos": pos})
            logits.append(lg.float().cpu().numpy())
        out[f"{tag}.logits"] = np.stack(logits)
    return out


CASES = {"forward": case_forward, "steps": case_steps,
         "payloads": case_payloads, "ckpt": case_ckpt,
         "zero1_fault": case_zero1_fault, "card": case_card}


def main(spec_path, out_dir):
    with open(spec_path) as f:
        spec = json.load(f)
    torch.manual_seed(0)
    device = spec.get("device", "cpu")
    if device == "cuda":
        torch.cuda.set_device(0)          # every rank on the one card
    mesh, rank, world = local_world.join("gloo", device, spec["mesh"],
                                         ("data", "model"))
    ctx = {"spec": spec, "mesh": mesh, "rank": rank, "world": world,
           "n_dp": spec["mesh"][0], "tp": spec["mesh"][1],
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
