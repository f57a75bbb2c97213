"""The port's data-parallel training held against the JAX package's on the
CPU (tests/test_distributed_loader.py's int8 all-reduce, local-accumulation
and ZeRO-1 tests; tests/test_checkpoint.py's elastic reshard).

Once a module, at the same time: a 4-rank gloo world of the port on a
``(4, 1)`` ``("data", "model")`` mesh and a 2-rank one on ``(2, 1)``
(``tests/torch_train_world.py``, spawned with a ``file://`` rendezvous
under ``tmp_path``), and the reference on 4 forced host devices
(``devices4``: the same steps on a ``(4, 1)`` mesh, the int8 payloads
read by ``jax.debug.callback``).  Before them, the reference saves a
reduced phi4-mini state on its ``(4, 2)`` mesh with ``fsdp=True`` and
records each device's shard on ``(2, 2)`` and ``(2, 1)`` meshes
(``devices8``); the 4-rank world then restores it on ``(2, 2)``.  Weights
cross with ``params_from_jax``; the batch is the reference test's.

Tolerances: the int8 payloads and scales bitwise; the sums within 0.03
(``compressed_allreduce``) and 0.01 (``compressed_psum``) of the exact
one, relative to its largest magnitude (the reference's own bounds).  The
local-accumulation step's params within rtol 3e-3, atol 3e-5 and ZeRO-1's
within rtol 5e-3, atol 5e-5 of the reference's ``make_train_step`` (the
reference tests' bounds; the optimizer config's warm-up makes step 0's
learning rate 0).  So the moments, ``0.1 g`` and ``0.05 g^2``, are where
the gradients show: each leaf of ``mu`` within ``GRAD_TOL`` (5e-2, the
measured bound of tests/torch_train_ref.py) of its largest magnitude, and
of ``nu`` within twice that, against the reference's.  The
int8 step's parameters are not held elementwise: Adam's first update
turns a gradient into about +-lr, so a quantum rounding the other way at a
tie (the packages' gradients differ by an ulp) moves an element by a whole
lr; its loss must fall over 5 steps, as the reference's test asks.
Losses across the packages at ``TRAIN_RTOL`` and gradient norms at five
times it (tests/torch_train_ref.py).  Replicated parameters, restored
checkpoints and reshards: bitwise.
"""
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ref as R
from conftest import run_devices_subprocess
from repro.checkpoint import io as jckpt
from repro.configs import reduced_config as jreduced
from repro.models import abstract_params
from repro.models import init_params as jinit
from repro.train.step import abstract_zero1_local_state as jabstract_zero1
from repro.train.step import make_zero1_local_state as jmake_zero1
from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.transformer import Transformer, reference_paths
from repro_torch.scripts import local_world

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))
ARCH = "phi4-mini-3.8b"
WORLD = 4
LOCAL_TOL = dict(rtol=3e-3, atol=3e-5)
ZERO1_TOL = dict(rtol=5e-3, atol=5e-5)


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(l)
            for path, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


_SAVE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.compat import make_mesh, device_mesh
from repro.checkpoint import io as ckpt_io
from repro.checkpoint.reshard import reshard_restore
from repro.configs import reduced_config
from repro.models import init_params
from repro.distributed import sharding as shd
from repro.train.state import TrainState, abstract_state

out = sys.argv[1]
cfg = reduced_config("phi4-mini-3.8b")
params = init_params(jax.random.key(2), cfg)
leaves, tree = jax.tree.flatten(params)
keys = jax.random.split(jax.random.key(3), 2 * len(leaves))
mu = jax.tree.unflatten(tree, [jax.random.normal(k, l.shape)
                               for k, l in zip(keys[::2], leaves)])
nu = jax.tree.unflatten(tree, [jnp.abs(jax.random.normal(k, l.shape))
                               for k, l in zip(keys[1::2], leaves)])
state = TrainState(jnp.asarray(5, jnp.int32), params, mu, nu, None)
mesh8 = make_mesh((4, 2), ("data", "model"))
ap = jax.eval_shape(lambda: params)
ps = shd.param_shardings(ap, cfg, mesh8, fsdp=True)
ms = shd.moment_shardings(ap, ps, mesh8)
sh = TrainState(NamedSharding(mesh8, P()), ps, ms, ms, None)
ckpt_io.save(jax.device_put(state, sh), out + "/reshard", 5)

def bounds(idx, shape):
    return [[s.start or 0, d if s.stop is None else s.stop]
            for s, d in zip(idx, shape)]

index = {}
for shape in ((2, 2), (2, 1)):
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = device_mesh(devs, ("data", "model"))
    st, at = reshard_restore(abstract_state(ap), out + "/reshard", cfg, mesh,
                             fsdp=True)
    assert at == 5
    rows = {}
    for tag, t in (("p", st.params), ("mu", st.mu), ("nu", st.nu)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            key = ".".join(str(getattr(k, "key", k)) for k in path)
            imap = leaf.sharding.devices_indices_map(leaf.shape)
            rows[f"{tag}.{key}"] = [bounds(imap[d], leaf.shape)
                                    for d in devs.reshape(-1)]
    index["x".join(map(str, shape))] = rows
with open(out + "/reshard_index.json", "w") as f:
    json.dump(index, f)
print("SAVE-OK")
"""

_STEPS = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.compat import make_mesh, shard_map
from repro.configs import reduced_config
from repro.distributed import compression as C
from repro.train.optimizer import OptimizerConfig
from repro.train.state import init_state
from repro.train.step import (make_train_step, make_local_accum_train_step,
                              make_zero1_local_state)

inp, out = sys.argv[1], sys.argv[2]
z = dict(np.load(inp))
params = {}
for key, v in z.items():
    if key.startswith("w."):
        *parents, leaf = key[2:].split(".")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
cfg = reduced_config("phi4-mini-3.8b")
oc = OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=50)
batch = {"tokens": jnp.asarray(z["tokens"]), "labels": jnp.asarray(z["labels"])}
res = {}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        res[prefix + key] = np.asarray(leaf)

s, m = jax.jit(make_train_step(cfg, oc, accum_steps=2))(init_state(params),
                                                         batch)
put("single.p.", s.params); put("single.mu.", s.mu); put("single.nu.", s.nu)
res["single.loss"], res["single.grad_norm"] = float(m["loss"]), \
    float(m["grad_norm"])
mesh = make_mesh((4, 1), ("data", "model"))
with mesh:
    s, m = jax.jit(make_local_accum_train_step(cfg, oc, mesh, accum_steps=2))(
        init_state(params), batch)
    put("local.p.", s.params); put("local.mu.", s.mu); put("local.nu.", s.nu)
    res["local.loss"] = float(m["loss"])
    sz = make_zero1_local_state(params, 4)
    sz, m = jax.jit(make_local_accum_train_step(
        cfg, oc, mesh, accum_steps=2, zero1=True))(sz, batch)
    put("zero1.p.", sz.params); put("zero1.mu.", sz.mu); put("zero1.nu.", sz.nu)
    res["zero1.loss"], res["zero1.grad_norm"] = float(m["loss"]), \
        float(m["grad_norm"])

seen = {}
real = C.quantize_int8

def recording(x):
    q, s = real(x)
    jax.debug.callback(lambda i, q, s: seen.setdefault(
        (q.ndim, int(i)), (np.asarray(q), np.asarray(s))),
        jax.lax.axis_index("data"), q, s)
    return q, s

mesh4 = make_mesh((4,), ("data",))
x = jnp.asarray(z["allreduce_x"])
C.quantize_int8 = recording
y = jax.jit(shard_map(lambda xs: C.compressed_allreduce(xs[0], "data", 4)[None],
                      mesh=mesh4, in_specs=P("data"), out_specs=P("data")))(x)
jax.block_until_ready(y)
jax.effects_barrier()
C.quantize_int8 = real
y2 = jax.jit(shard_map(lambda xs: C.compressed_psum(xs, "data"), mesh=mesh4,
                       in_specs=P("data"), out_specs=P("data")))(x)
res["y"], res["y2"] = np.asarray(y), np.asarray(y2)
for k in range(4):
    res[f"q_send{k}"], res[f"s_send{k}"] = seen[(2, k)]
    res[f"q_sum{k}"], res[f"s_sum{k}"] = seen[(1, k)]
np.savez(out, **res)
print("STEPS-OK")
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, devices8, devices4):
    """Every run once; returns ``SimpleNamespace(out, ref, index, ...)``."""
    tmp = tmp_path_factory.mktemp("dp_train")
    out = tmp / "out"
    out.mkdir()
    jcfg = jreduced(ARCH)
    params = jinit(jax.random.key(0), jcfg)
    toks = np.asarray(jax.random.randint(jax.random.key(7), (8, 33), 0,
                                         jcfg.vocab_size))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(WORLD, 33)).astype(np.float32)
    x *= np.array([1.0, 10.0, 0.1, 3.0], np.float32)[:, None]
    inputs = tmp / "inputs.npz"
    np.savez(inputs, tokens=toks[:, :-1].copy(), labels=toks[:, 1:].copy(),
             allreduce_x=x,
             **{f"w.{k}": v for k, v in _flat(params).items()})

    # the reference's ZeRO-1 checkpoint at n_dp=4, moments drawn at random
    zs = jmake_zero1(params, WORLD)
    mleaves, mtree = jax.tree.flatten(zs.mu)
    draw = [rng.normal(size=m.shape).astype(np.float32) for m in mleaves]
    zs.mu = jax.tree.unflatten(mtree, [jnp.asarray(d) for d in draw])
    zs.nu = jax.tree.unflatten(mtree, [jnp.asarray(np.abs(d) * 0.5)
                                       for d in draw])
    zs.step = jnp.asarray(3, jnp.int32)
    jckpt.save(zs, str(tmp / "zero1_ref"), 3)

    # the reference's (4, 2)-mesh save comes first: the worlds restore it
    assert "SAVE-OK" in devices8(
        f"import sys\nsys.argv = ['ref', {str(tmp)!r}]\n" + _SAVE,
        timeout=300)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]))
    specs = {}
    for name, mesh, reshard_mesh, cases in (
            ("w4", [WORLD, 1], [2, 2], ["allreduce", "steps",
                                        "zero1_from_reference", "reshard"]),
            ("w2", [2, 1], [2, 1], ["reshard"])):
        d = out / name
        d.mkdir()
        spec = {"arch": ARCH, "mesh": mesh, "reshard_mesh": reshard_mesh,
                "inputs": str(inputs), "cases": cases,
                "zero1_ref_dir": str(tmp / "zero1_ref"),
                "zero1_port_dir": str(tmp / "zero1_port"),
                "reshard_dir": str(tmp / "reshard")}
        (d / "spec.json").write_text(json.dumps(spec))
        specs[name] = (d, mesh[0] * mesh[1])

    with ThreadPoolExecutor(len(specs)) as pool:
        runs = {name: pool.submit(
            local_world.spawn,
            [sys.executable, os.path.join(HERE, "torch_train_world.py"),
             str(d / "spec.json"), str(d)], n, timeout=400, env=env,
            workdir=str(d)) for name, (d, n) in specs.items()}
        ref_out = tmp / "ref.npz"
        code = (f"import sys\nsys.argv = ['ref', {str(inputs)!r}, "
                f"{str(ref_out)!r}]\n" + _STEPS)
        assert "STEPS-OK" in devices4(code, timeout=400)
        results = {name: f.result() for name, f in runs.items()}
    for name, rs in results.items():
        for k, run in enumerate(rs):
            assert run.returncode == 0, \
                f"{name} rank {k}:\n{run.stdout}{run.stderr[-4000:]}"
    errors = {}
    for name, (d, n) in specs.items():
        for k in range(n):
            rep = json.loads((d / f"rank{k}.json").read_text())
            errors.update({f"{name}/{k}/{c}": e
                           for c, e in rep["errors"].items()})
    index = json.loads((tmp / "reshard_index.json").read_text())
    return SimpleNamespace(tmp=tmp, specs=specs, errors=errors,
                           ref=dict(np.load(ref_out)), index=index,
                           params=params, inputs=dict(np.load(inputs)))


def _case(w, world, case, rank):
    assert not any(k.startswith(f"{world}/") and k.endswith(f"/{case}")
                   for k in w.errors), w.errors
    return dict(np.load(w.specs[world][0] / f"{case}_{rank}.npz"))


def _port_as_reference(got, prefix, cfg=None):
    """The port's per-layer arrays under ``prefix`` stacked into the
    reference's leaves."""
    cfg = cfg or configs.reduced_config(ARCH)
    model = Transformer(cfg, device="meta", dtype=torch.float32)
    paths = reference_paths(model)
    stacked = {}
    for name in paths:
        path, j = paths[name]
        arr = got[prefix + name]
        if j is None:
            stacked[path] = arr
        else:
            stacked.setdefault(path, {})[j] = arr
    return {k: (v if not isinstance(v, dict)
                else np.stack([v[j] for j in range(len(v))]))
            for k, v in stacked.items()}


# ---- the int8 all-reduce --------------------------------------------------------

@pytest.mark.parametrize("rank", range(WORLD))
def test_compressed_allreduce_payloads_match_the_reference(worlds, rank):
    got, ref = _case(worlds, "w4", "allreduce", rank), worlds.ref
    for key in ("q_send", "s_send", "q_sum", "s_sum"):
        assert got[key].dtype == ref[f"{key}{rank}"].dtype, key
        assert np.array_equal(got[key], ref[f"{key}{rank}"]), key
    assert np.array_equal(got["y"], ref["y"][rank])
    exact = worlds.inputs["allreduce_x"].sum(0)
    scale = np.abs(exact).max()
    assert np.abs(got["y"] - exact).max() / scale < 0.03
    assert np.abs(got["y2"] - exact).max() / scale < 0.01
    np.testing.assert_allclose(got["y2"], ref["y2"][rank], rtol=1e-6,
                               atol=1e-6 * scale)


# ---- the steps -----------------------------------------------------------------

def _hold(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **tol)


def _hold_moment(got, want, tag, what):
    """Each leaf within ``GRAD_TOL`` of its largest magnitude (``mu``),
    twice that for ``nu``."""
    assert sorted(got) == sorted(want), what
    tol = R.GRAD_TOL * (2 if tag == "nu" else 1)
    for k in want:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= tol, (what, k, err)


def test_local_accum_step_matches_the_reference(worlds):
    got, ref = _case(worlds, "w4", "steps", 0), worlds.ref
    for tag in ("p", "mu", "nu"):
        port = _port_as_reference(got, f"local.{tag}.")
        for against in ("single", "local"):
            want = {k[len(f"{against}.{tag}."):]: v for k, v in ref.items()
                    if k.startswith(f"{against}.{tag}.")}
            if tag == "p":
                _hold(port, want, LOCAL_TOL, f"local p vs {against}")
            else:
                _hold_moment(port, want, tag, f"local {tag} vs {against}")
    _hold(_port_as_reference(got, "local.p."),
          _port_as_reference(got, "single.p."), LOCAL_TOL, "port single")
    for against in ("single", "local"):
        np.testing.assert_allclose(got["local.loss"], ref[f"{against}.loss"],
                                   rtol=R.TRAIN_RTOL)
    np.testing.assert_allclose(got["local.loss"], got["single.loss"],
                               rtol=R.TRAIN_RTOL)
    np.testing.assert_allclose(got["local.grad_norm"],
                               ref["single.grad_norm"], rtol=5 * R.TRAIN_RTOL)


def test_zero1_step_matches_the_reference(worlds):
    got, ref = _case(worlds, "w4", "steps", 0), worlds.ref
    _hold(_port_as_reference(got, "zero1.p."),
          {k[len("single.p."):]: v for k, v in ref.items()
           if k.startswith("single.p.")}, ZERO1_TOL, "zero1 params")
    np.testing.assert_allclose(got["zero1.loss"], ref["zero1.loss"],
                               rtol=R.TRAIN_RTOL)
    np.testing.assert_allclose(got["zero1.grad_norm"],
                               ref["zero1.grad_norm"], rtol=5 * R.TRAIN_RTOL)
    np.testing.assert_allclose(got["zero1.loss"], got["local.loss"],
                               rtol=1e-6)
    sizes = {k: v.size for k, v in _port_as_reference(got, "zero1.p.")
             .items()}
    for tag in ("mu", "nu"):
        port = {k[len(f"zero1.{tag}."):]: v for k, v in got.items()
                if k.startswith(f"zero1.{tag}.")}
        want = {k[len(f"zero1.{tag}."):]: v for k, v in ref.items()
                if k.startswith(f"zero1.{tag}.")}
        for k, v in port.items():
            assert v.shape == (WORLD, -(-sizes[k] // WORLD)), k
            assert v.shape == want[k].shape, k
        _hold_moment(port, want, tag, f"zero1 {tag}")
    for k in range(WORLD):
        mine = _case(worlds, "w4", "steps", k)
        for key, v in mine.items():
            if key.startswith("zero1.mu_local."):
                full = got["zero1.mu." + key[len("zero1.mu_local."):]]
                assert np.array_equal(v, full[k:k + 1]), (k, key)


def test_int8_step_loss_falls(worlds):
    losses = _case(worlds, "w4", "steps", 0)["int8.losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("key", ["local.checksum", "zero1.step3",
                                 "int8.checksum", "int8.losses"])
def test_replicated_state_is_bitwise_equal_on_every_rank(worlds, key):
    first = _case(worlds, "w4", "steps", 0)[key]
    for k in range(1, WORLD):
        assert np.array_equal(_case(worlds, "w4", "steps", k)[key], first), k


@pytest.mark.parametrize("rank", range(WORLD))
def test_zero1_checkpoint_replays_bitwise(worlds, rank):
    got = _case(worlds, "w4", "steps", rank)
    assert int(got["zero1.replayed_step"]) == 2
    assert np.array_equal(got["zero1.replayed"], got["zero1.step3"])
    assert np.array_equal(got["zero1.replayed_mu"], got["zero1.step3_mu"])


def test_a_port_zero1_checkpoint_restores_in_the_reference(worlds):
    got = _case(worlds, "w4", "steps", 0)
    abstract = jabstract_zero1(abstract_params(jreduced(ARCH)), WORLD)
    js, at = jckpt.restore(abstract, str(worlds.tmp / "zero1_port"))
    assert at == 1 and int(js.step) == 1
    port = _port_as_reference(got, "zero1.p.")
    for k, v in _flat(js.params).items():
        assert np.array_equal(v, port[k]), k
    for tag, tree in (("mu", js.mu), ("nu", js.nu)):
        for k, v in _flat(tree).items():
            assert np.array_equal(v, got[f"zero1.{tag}.{k}"]), (tag, k)


@pytest.mark.parametrize("rank", range(WORLD))
def test_a_reference_zero1_checkpoint_restores_in_the_port(worlds, rank):
    got = _case(worlds, "w4", "zero1_from_reference", rank)
    js = jckpt.restore(jabstract_zero1(abstract_params(jreduced(ARCH)),
                                       WORLD), str(worlds.tmp / "zero1_ref"))[0]
    assert got["step"].tolist() == [3, 3]
    for tag, tree in (("mu", js.mu), ("nu", js.nu)):
        for k, v in _flat(tree).items():
            assert np.array_equal(got[f"{tag}.{k}"], v[rank:rank + 1]), k
    port = _port_as_reference(got, "p.")
    for k, v in _flat(js.params).items():
        assert np.array_equal(port[k], v), k


# ---- elastic restore -----------------------------------------------------------

@pytest.mark.parametrize("world,shape", [("w4", "2x2"), ("w2", "2x1")])
def test_reshard_restore_gives_each_rank_the_reference_shard(worlds, world,
                                                             shape):
    """Rank r sits at mesh coordinate ``divmod(r, model)`` in both
    packages.  A param's local slice is the reference's shard there; so is
    a moment's, except where the ZeRO-1 rule shards the stacked layer
    axis, which a per-layer tensor cannot: that layer's moment is then
    whole on the rank and holds the reference's shard."""
    index = worlds.index[shape]
    n = worlds.specs[world][1]
    cfg = configs.reduced_config(ARCH)
    paths = reference_paths(Transformer(cfg, device="meta",
                                        dtype=torch.float32))
    d = worlds.tmp / "reshard" / "step_00000005"
    saved = {}
    for rank in range(n):
        got = _case(worlds, world, "reshard", rank)
        assert got["step"].tolist() == [5, 5]
        assert got["is_dtensor"].all() and got["full_equal"].all()
        for name, (path, j) in paths.items():
            for tag, idx in (("p", "1"), ("mu", "2"), ("nu", "3")):
                key = f"{idx}.{path}"
                if key not in saved:
                    saved[key] = np.load(d / f"{key}.npy")
                full, b = saved[key], index[f"{tag}.{path}"][rank]
                if j is not None:
                    (lo, hi), b = b[0], b[1:]
                    if hi - lo < full.shape[0]:     # the layer axis sharded
                        assert tag != "p", (name, rank)
                    full = full[j]
                want = full[tuple(slice(lo, hi) for lo, hi in b)]
                assert np.array_equal(got[f"{tag}.{name}"], want), \
                    (world, rank, tag, name)


# ---- what the step refuses ------------------------------------------------------

def test_a_cuda_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()


_TP_PAD = r"""
import numpy as np, jax
from repro.core.compat import device_mesh
from repro.configs import reduced_config
from repro.models import init_params
from repro.train.optimizer import OptimizerConfig
from repro.train.step import make_local_accum_train_step, make_zero1_local_state

cfg = reduced_config("phi4-mini-3.8b")
mesh = device_mesh(np.array(jax.devices()[:6]).reshape(3, 2),
                   ("data", "model"))
params = init_params(jax.random.key(0), cfg, 2)
toks = jax.random.randint(jax.random.key(7), (6, 17), 0, cfg.vocab_size)
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
for tp in (1, 2):
    step = make_local_accum_train_step(cfg, OptimizerConfig(), mesh, tp=tp,
                                       zero1=True)
    try:
        with mesh:
            jax.jit(step).lower(make_zero1_local_state(params, 3, tp), batch)
        print("TP", tp, "LOWERS")
    except TypeError as e:
        print("TP", tp, "TypeError", str(e).splitlines()[0])
"""


def test_reference_zero1_moments_outgrow_the_gradient_shard_at_tp2():
    """A known fault of the reference (ROADMAP, Carried notes):
    ``make_zero1_local_state`` pads each moment to a multiple of ``n_dp *
    tp``, the step's reduce-scatter pads the gradient to ``n_dp`` only.
    No leaf size of the reduced phi4-mini (64 to 16,384) is a multiple of
    3, so at ``n_dp = 3, tp = 2`` a moment row (``ceil(P / 6) * 2``
    elements) can be one longer than the gradient shard (``ceil(P /
    3)``) and the step does not trace; at ``tp = 1`` it does.  The port
    keeps the reference's moment layout and raises ``ValueError`` there
    (``tests/test_torch_tp_train.py``)."""
    out = run_devices_subprocess(_TP_PAD, num_devices=6, timeout=300)
    assert "TP 1 LOWERS" in out, out
    assert "TP 2 TypeError add got incompatible shapes for broadcasting" \
        in out, out
