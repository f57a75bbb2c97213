"""The port's local-accumulation step at ``fsdp=True`` on the CPU
(``tests/torch_fsdp_world.py``'s ``local`` case in gloo worlds).

* Against the reference: its ``make_local_accum_train_step`` runs jitted
  on 4 forced host devices (``devices4``) with the state placed as its
  ``build_cell`` places it at ``fsdp=True`` (parameters and, but for
  ZeRO-1's own layout, moments by ``param_shardings(fsdp=True)``) and the
  batch by ``batch_shardings``: the reduced phi4-mini at ``(2, 2)`` in
  ``local_accum``, ``local_accum_int8`` and ``local_zero1``, the reduced
  mixtral at ``(4, 1)`` in ``local_accum``, f32, from the same weights and
  batch.  After one step the port's parameters are within ``LOCAL_TOL``
  (``ZERO1_TOL``), its moments within ``GRAD_TOL`` of each leaf's
  largest magnitude (twice that for ``nu``), its loss at ``TRAIN_RTOL``
  and its gradient norm at five times it (``tests/test_torch_tp_train.py``'s
  bounds).  The reference's jit lays its outputs out by XLA's own
  choice, so values are compared, never layouts.
* Against the port's own ``fsdp=False`` step: two steps on the same
  weights give the same losses and gradient norms, and the pieces of the
  parameters and moments are bitwise what ``shard_model`` keeps of the
  ``fsdp=False`` state (f32, and the reduced mixtral's bf16 state); the
  gather at the step's entry is exact.
"""
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_fsdp_world as W
import torch_tp_ref as T
import torch_tp_world as TW
import torch_train_ref as R
from repro.configs import reduced_config as jreduced
from repro.models import init_params as jinit
from repro_torch import configs
from repro_torch.models.transformer import Transformer, reference_paths

LOCAL_TOL = dict(rtol=3e-3, atol=3e-5)
ZERO1_TOL = dict(rtol=5e-3, atol=5e-5)
PHI, MIX = "phi4-mini-3.8b", "mixtral-8x22b"
MODES = ("local_accum", "local_accum_int8", "local_zero1")
# world -> (mesh, arch, modes)
WORLDS = {"w22": ((2, 2), PHI, MODES), "w41": ((4, 1), MIX, MODES[:1])}
RUNS = [(w, mode) for w, (_, _, modes) in WORLDS.items() for mode in modes]
BATCH, SEQ = 8, 16

_REF = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.compat import make_mesh
from repro.configs import reduced_config
from repro.distributed import sharding as shd
from repro.train.optimizer import OptimizerConfig
from repro.train.state import TrainState
from repro.train.step import make_local_accum_train_step, make_zero1_local_state

out = sys.argv[1]
worlds = {WORLDS}
oc = OptimizerConfig(**{OC})
res = {{}}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        res[prefix + key] = np.asarray(jnp.asarray(leaf, jnp.float32))

for name, (inp, shape, arch, modes) in worlds.items():
    z = dict(np.load(inp))
    params = {{}}
    for key, v in z.items():
        if key.startswith(f"w.{{arch}}."):
            *parents, leaf = key[len(f"w.{{arch}}."):].split(".")
            node = params
            for p in parents:
                node = node.setdefault(p, {{}})
            node[leaf] = jnp.asarray(v)
    batch = {{k: jnp.asarray(z[f"b.{{arch}}.{{k}}"]) for k in ("tokens", "labels")}}
    cfg = reduced_config(arch)
    mesh = make_mesh(tuple(shape), ("data", "model"))
    tp = shape[1]
    pshard = shd.param_shardings(params, cfg, mesh, fsdp=True)
    rep = NamedSharding(mesh, P())
    bshard = shd.batch_shardings(mesh, batch)
    for mode in modes:
        zero1 = mode == "local_zero1"
        step = make_local_accum_train_step(
            cfg, oc, mesh, tp=tp, accum_steps={ACCUM},
            int8_allreduce=mode.endswith("int8"), zero1=zero1,
            batch_axes=("data",) if zero1 else shd.dp_axes(mesh))
        if zero1:
            state = make_zero1_local_state(params, shape[0], tp)
            mz = jax.tree.map(lambda _: NamedSharding(mesh, P("data", "model")),
                              state.mu)
            sshard = TrainState(rep, pshard, mz, mz, None)
        else:
            zeros = jax.tree.map(jnp.zeros_like, params)
            state = TrainState(jnp.zeros((), jnp.int32), params, zeros, zeros,
                               None)
            sshard = TrainState(rep, pshard, pshard, pshard, None)
        with mesh:
            s, m = jax.jit(step, in_shardings=(sshard, bshard))(
                jax.device_put(state, sshard), jax.device_put(batch, bshard))
        put(f"{{name}}.{{mode}}.p.", s.params)
        put(f"{{name}}.{{mode}}.mu.", s.mu)
        put(f"{{name}}.{{mode}}.nu.", s.nu)
        res[f"{{name}}.{{mode}}.loss"] = float(m["loss"])
        res[f"{{name}}.{{mode}}.grad_norm"] = float(m["grad_norm"])
np.savez(out, **res)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, devices4):
    tmp = tmp_path_factory.mktemp("fsdp_local")
    spec, runs = {}, {}
    for name, (mesh, arch, modes) in WORLDS.items():
        jp = jinit(jax.random.key(T.SEED), jreduced(arch), mesh[1])
        batch = TW.kind_batch(configs.reduced_config(arch), b=BATCH, s=SEQ)
        inputs = tmp / f"inputs_{name}.npz"
        np.savez(inputs, **{f"w.{arch}.{k}": v
                            for k, v in T.flat_params(jp).items()},
                 **{f"b.{arch}.{k}": v for k, v in batch.items()})
        spec[name] = (str(inputs), list(mesh), arch, list(modes))
        runs[name] = T.spawn_world(tmp, name, mesh, ["local"], inputs,
                                   script="torch_fsdp_world.py",
                                   archs=[arch], local_modes=list(modes))
    out = tmp / "ref.npz"
    code = (f"import sys\nsys.argv = ['ref', {str(out)!r}]\n" +
            _REF.format(WORLDS=repr(spec), OC=W.LOCAL_OC, ACCUM=W.ACCUM))
    with ThreadPoolExecutor(1) as pool:
        assert "REF-OK" in pool.submit(devices4, code, timeout=500).result()
    errors = {}
    for name, (_, _, wait) in runs.items():
        errors.update(wait())
    return SimpleNamespace(runs=runs, errors=errors, ref=dict(np.load(out)))


def _got(w, world, rank=0):
    return T.case(w.runs[world][0], w.errors, "local", rank)


def _stacked(got, prefix, arch, tp):
    paths = reference_paths(Transformer(configs.reduced_config(arch), tp=tp,
                                        device="meta"))
    stacked = {}
    for name, (path, j) in paths.items():
        arr = got[prefix + name]
        if j is None:
            stacked[path] = arr
        else:
            stacked.setdefault(path, {})[j] = arr
    return {k: (v if not isinstance(v, dict)
                else np.stack([v[j] for j in range(len(v))]))
            for k, v in stacked.items()}


def _ref(w, prefix):
    return {k[len(prefix):]: v for k, v in w.ref.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("world,mode", RUNS)
def test_local_step_at_fsdp_matches_the_reference(worlds, world, mode):
    mesh, arch, _ = WORLDS[world]
    got = _got(worlds, world)
    key = f"{arch}.{mode}.f32"
    tol = ZERO1_TOL if mode == "local_zero1" else LOCAL_TOL
    port = _stacked(got, f"{key}.first.p.", arch, mesh[1])
    want = _ref(worlds, f"{world}.{mode}.p.")
    assert sorted(port) == sorted(want)
    for k in want:
        np.testing.assert_allclose(port[k], want[k], err_msg=k, **tol)
    for tag in ("mu", "nu"):
        want = _ref(worlds, f"{world}.{mode}.{tag}.")
        if mode == "local_zero1":
            mine = {k[len(f"{key}.first.{tag}."):]: v for k, v in got.items()
                    if k.startswith(f"{key}.first.{tag}.")}
        else:
            mine = _stacked(got, f"{key}.first.{tag}.", arch, mesh[1])
        assert sorted(mine) == sorted(want), tag
        bound = R.GRAD_TOL * (2 if tag == "nu" else 1)
        for k in want:
            assert mine[k].shape == want[k].shape, (tag, k)
            err = np.abs(mine[k] - want[k]).max() / np.abs(want[k]).max()
            assert err <= bound, (tag, k, err)
    loss, gnorm = got[f"{key}.metrics"][0]
    np.testing.assert_allclose(loss, worlds.ref[f"{world}.{mode}.loss"],
                               rtol=R.TRAIN_RTOL)
    np.testing.assert_allclose(gnorm,
                               worlds.ref[f"{world}.{mode}.grad_norm"],
                               rtol=5 * R.TRAIN_RTOL)


def _keys(world):
    _, arch, modes = WORLDS[world]
    out = [f"{arch}.{m}.f32" for m in modes]
    if arch in configs.BF16_STATE_ARCHS:
        out.append(f"{arch}.local_accum.bf16")
    return out


@pytest.mark.parametrize("world,key", [(w, k) for w in WORLDS
                                       for k in _keys(w)])
def test_local_step_at_fsdp_equals_it_unsharded_bitwise(worlds, world, key):
    """Every rank: the same losses and norms, and its pieces bitwise those
    of the ``fsdp=False`` state, which hold more elements."""
    mesh, _, _ = WORLDS[world]
    for rank in range(mesh[0] * mesh[1]):
        got = _got(worlds, world, rank)
        assert bool(got[f"{key}.bitwise"]), (rank, key)
        assert np.array_equal(got[f"{key}.metrics"],
                              got[f"{key}.metrics_whole"]), rank
        assert np.all(np.isfinite(got[f"{key}.metrics"]))
        sharded, whole = got[f"{key}.numel"]
        assert sharded < whole, (rank, sharded, whole)
