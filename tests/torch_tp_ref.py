"""Helpers shared by the port's tensor-parallel parity tests on the CPU
(test_torch_tp, test_torch_tp_train): the reference's function at a
given ``tp`` computed in-process on one CPU device, op by op (the
partitioner spreads that same function over a mesh), the port's gloo
worlds (``tests/torch_tp_world.py``) spawned beside it, and the holds.

Imports jax; not collected by pytest.  Tolerances are the repo's own
(``torch_models_ref.TOL`` for logits, ``torch_train_ref.LOSS_RTOL`` and
``GRAD_TOL`` for the loss and the gradients, all measured against the
reference run op by op).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_models_ref as M
import torch_tp_world as W
import torch_train_ref as R
from repro import configs as jconfigs
from repro.models import forward_decode as jdecode
from repro.models import forward_prefill as jprefill
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro_torch import configs
from repro_torch.distributed.sharding import cache_model_dim, param_pspec
from repro_torch.models.transformer import (Transformer, init_caches,
                                            reference_paths)
from repro_torch.scripts import local_world

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
ARCHS = tuple(configs.ARCHS)
SEED = 1


def flat_params(jp):
    return R.flat(jax.tree_util.tree_map(np.asarray, jp))


def reference(arch, tp):
    """The reference's loss and gradients, prefill logits and teacher-
    forced decode logits for the reduced ``arch``'s ``init_params(key,
    cfg, tp)`` (padded heads), op by op: ``(its params as numpy,
    results)``."""
    jcfg = jconfigs.reduced_config(arch)
    cfg = configs.reduced_config(arch)
    jp = jinit(jax.random.key(SEED), jcfg, tp)
    batch = W.kind_batch(cfg)
    out = {}
    with jax.disable_jit():
        loss, grads = jax.value_and_grad(jloss)(jp, R.jax_batch(batch), jcfg,
                                                tp)
        out["loss"] = float(loss)
        out["grads"] = R.flat(jax.tree_util.tree_map(np.asarray, grads))
        prompt = {k: (M.jbf(v) if v.dtype == np.float32 else jnp.asarray(v))
                  for k, v in batch.items() if k != "labels"}
        lg, caches = jprefill(jp, prompt, jcfg, W.MAX_SEQ, tp)
        out["logits0"] = np.asarray(lg.astype(jnp.float32))
        for i, tok in enumerate(W.decode_tokens(cfg)):
            pos = jnp.full((W.BATCH,), W.SEQ + i, jnp.int32)
            lg, caches = jdecode(jp, {"token": jnp.asarray(tok), "pos": pos},
                                 caches, jcfg, W.MAX_SEQ, tp)
            out[f"logits{i + 1}"] = np.asarray(lg.astype(jnp.float32))
    return flat_params(jp), out


def spawn_world(tmp, name, mesh, cases, inputs,
                script="torch_tp_world.py", **extra):
    """Start a gloo world of ``mesh[0] * mesh[1]`` ranks of the world
    ``script`` in the background; returns ``(directory, size, future-like
    callable that waits and returns the ranks' errors)``."""
    from concurrent.futures import ThreadPoolExecutor
    d = tmp / name
    d.mkdir()
    spec = {"mesh": list(mesh), "inputs": str(inputs), "cases": cases,
            **extra}
    (d / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]))
    n = mesh[0] * mesh[1]
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(local_world.spawn,
                      [sys.executable, os.path.join(HERE, script),
                       str(d / "spec.json"), str(d)], n, timeout=600,
                      env=env, workdir=str(d))

    def wait():
        runs = fut.result()
        pool.shutdown()
        for k, run in enumerate(runs):
            assert run.returncode == 0, \
                f"{name} rank {k}:\n{run.stdout}{run.stderr[-4000:]}"
        errors = {}
        for k in range(n):
            rep = json.loads((d / f"rank{k}.json").read_text())
            errors.update({f"{name}/{k}/{c}": e
                           for c, e in rep["errors"].items()})
        return errors
    return d, n, wait


def case(d, errors, case_name, rank):
    assert not any(k.endswith(f"/{case_name}") for k in errors), errors
    return dict(np.load(d / f"{case_name}_{rank}.npz"))


def hold_forward(got, arch, ref):
    """The port's world against the reference at one ``tp``: the loss at
    ``LOSS_RTOL``, each gradient within ``GRAD_TOL`` of its leaf's largest
    magnitude, every step's logits at ``TOL``."""
    cfg = configs.reduced_config(arch)
    np.testing.assert_allclose(got[f"{arch}.loss"], ref["loss"],
                               rtol=R.LOSS_RTOL, err_msg=f"{arch} loss")
    model = Transformer(cfg, tp=1, device="meta")
    for name, (path, j) in reference_paths(model).items():
        want = R.at(ref["grads"], path, j)
        scale = float(np.abs(ref["grads"][path]).max())
        np.testing.assert_allclose(got[f"{arch}.g.{name}"], want, rtol=0,
                                   atol=R.GRAD_TOL * scale,
                                   err_msg=f"{arch} grad {name}")
    for i in range(W.DECODE_STEPS + 1):
        M.close(got[f"{arch}.logits{i}"], ref[f"logits{i}"],
                f"{arch} logits step {i}")
        if i:
            assert np.array_equal(got[f"{arch}.next{i}"],
                                  np.argmax(got[f"{arch}.logits{i}"], -1))


def hold_pieces(got, arch, tp):
    """Each rank holds ``1/tp`` of every leaf ``param_pspec`` splits over
    ``"model"`` and of every cache leaf ``cache_pspec`` splits, the whole
    of the rest."""
    cfg = configs.reduced_config(arch)
    model = Transformer(cfg, tp=tp, device="meta")
    paths = reference_paths(model)
    count = {}
    for path, j in paths.values():
        count[path] = max(count.get(path, 0), (j or 0) + 1)
    axes = {"data": 1, "model": tp}
    for name, p in model.named_parameters():
        path, j = paths[name]
        lead = () if j is None else (count[path],)
        spec = param_pspec(tuple(path.split(".")), lead + tuple(p.shape),
                           cfg, axes, fsdp=False)
        split = "model" in spec
        want = p.numel() // tp if split else p.numel()
        assert int(got[f"{arch}.numel.{name}"]) == want, (arch, name, spec)
    whole = init_caches(cfg, W.BATCH, W.MAX_SEQ, device="meta")
    for layer, c in enumerate(whole):
        for k, t in c.items():
            shape = list(t.shape)
            dim = cache_model_dim(k, shape, cfg, tp)
            if dim is not None:
                shape[dim] //= tp
            assert list(got[f"{arch}.cache.{layer}.{k}"]) == shape, \
                (arch, layer, k, dim)
