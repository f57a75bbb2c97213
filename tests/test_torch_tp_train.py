"""The port's tensor-parallel execution held against the JAX package on the
CPU at ``tp = 2``, and its training steps and checkpoints on
``("data", "model")`` meshes (``tests/torch_tp_world.py``'s gloo worlds).

* A ``(1, 2)`` world runs every reduced arch from the reference's
  ``init_params(key, cfg, 2)``: 2 splits every matrix (heads, KV heads,
  ``d_ff``, the 256-row vocabulary, the 4 experts, the recurrent kinds'
  channels) but the two archs' single KV head, whose caches split over
  positions.  Held as ``tests/test_torch_tp.py`` holds ``tp = 3``.
* A ``(2, 2)`` world runs the reduced phi4-mini's local-accumulation step
  in f32, ZeRO-1 and int8 modes against the reference's
  ``make_local_accum_train_step(..., tp=2)`` on a ``(2, 2)`` mesh of
  forced host devices (``devices4``): params within ``LOCAL_TOL`` /
  ``ZERO1_TOL`` (``tests/test_torch_dp_train.py``'s bounds), moments within
  ``GRAD_TOL`` of each leaf's largest magnitude (twice that for ``nu``),
  losses at ``TRAIN_RTOL``, gradient norms at five times it.  The step's
  int8 reduction of injected gradients gives the reference's
  ``compressed_allreduce`` payloads and sums over a data axis of 2,
  bitwise.
* The reference's ``tp = 2`` checkpoint restores into the ``(1, 2)`` and
  ``(2, 2)`` worlds, each rank its pieces, bitwise; each world saves it
  again and the reference restores that bitwise; ``reshard_restore`` +
  ``shard_model`` gives the same model.
* A ``(3, 2)`` world's ZeRO-1 step raises the port's ``ValueError``
  where the reference's moments outgrow the gradient shard.
"""
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ref as T
import torch_tp_world as W
import torch_train_ref as R
from repro.checkpoint import io as jckpt
from repro.configs import reduced_config as jreduced
from repro.models import abstract_params
from repro.models import init_params as jinit
from repro.train.state import TrainState as JState
from repro_torch import configs
from repro_torch.distributed import tensor_parallel as tpar
from repro_torch.models.transformer import Transformer, reference_paths

TP = 2
ARCH = W.STEP_ARCH
LOCAL_TOL = dict(rtol=3e-3, atol=3e-5)
ZERO1_TOL = dict(rtol=5e-3, atol=5e-5)
PAYLOAD_LEAVES = ("embed", "seg0.sub0.attn.wq", "seg0.sub0.mlp.w_out",
                  "seg0.sub0.norm1")

_STEPS = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.compat import make_mesh, shard_map
from repro.configs import reduced_config
from repro.distributed import compression as C
from repro.train.optimizer import OptimizerConfig
from repro.train.state import init_state
from repro.train.step import make_local_accum_train_step, make_zero1_local_state

inp, out = sys.argv[1], sys.argv[2]
z = dict(np.load(inp))
params = {}
for key, v in z.items():
    if key.startswith("w.phi4-mini-3.8b."):
        *parents, leaf = key[len("w.phi4-mini-3.8b."):].split(".")
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

mesh = make_mesh((2, 2), ("data", "model"))
with mesh:
    s, m = jax.jit(make_local_accum_train_step(cfg, oc, mesh, accum_steps=2,
                                               tp=2))(init_state(params), batch)
    put("local.p.", s.params); put("local.mu.", s.mu); put("local.nu.", s.nu)
    res["local.loss"], res["local.grad_norm"] = float(m["loss"]), \
        float(m["grad_norm"])
    sz = make_zero1_local_state(params, 2, 2)
    sz, m = jax.jit(make_local_accum_train_step(
        cfg, oc, mesh, accum_steps=2, zero1=True, tp=2))(sz, batch)
    put("zero1.p.", sz.params); put("zero1.mu.", sz.mu); put("zero1.nu.", sz.nu)
    res["zero1.loss"], res["zero1.grad_norm"] = float(m["loss"]), \
        float(m["grad_norm"])

# the int8 all-reduce over a data axis of 2 (each model column of the
# (2, 2) mesh runs it), its payloads read by jax.debug.callback
mesh2 = make_mesh((2,), ("data",))
real = C.quantize_int8
for li, path in enumerate(sys.argv[3].split(",")):
    seen = {}

    def recording(x, _calls=[0]):
        q, s = real(x)
        call = _calls[0]
        _calls[0] += 1
        jax.debug.callback(lambda i, q, s: seen.setdefault(
            (call, int(i)), (np.asarray(q), np.asarray(s))),
            jax.lax.axis_index("data"), q, s)
        return q, s

    x = jnp.asarray(z["g." + path])
    C.quantize_int8 = recording
    y = jax.jit(shard_map(lambda xs: C.compressed_allreduce(xs[0], "data",
                                                            2)[None],
                          mesh=mesh2, in_specs=P("data"),
                          out_specs=P("data")))(x)
    jax.block_until_ready(y)
    jax.effects_barrier()
    C.quantize_int8 = real
    res[f"{path}.y"] = np.asarray(y)
    for k in range(2):
        res[f"{path}.q_send{k}"], res[f"{path}.s_send{k}"] = seen[(0, k)]
        res[f"{path}.q_sum{k}"], res[f"{path}.s_sum{k}"] = seen[(1, k)]
np.savez(out, **res)
print("STEPS-OK")
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, devices4):
    """Every run once: the ``(1, 2)``, ``(2, 2)`` and ``(3, 2)`` worlds,
    the reference's ``(2, 2)`` steps and the ``tp = 2`` forward."""
    tmp = tmp_path_factory.mktemp("tp2")
    weights, step_params = {}, None
    for arch in T.ARCHS:
        jp = jinit(jax.random.key(T.SEED), jreduced(arch), TP)
        weights.update({f"w.{arch}.{k}": v
                        for k, v in T.flat_params(jp).items()})
        if arch == ARCH:
            step_params = jp
    jcfg = jreduced(ARCH)
    toks = np.asarray(jax.random.randint(jax.random.key(7), (8, 33), 0,
                                         jcfg.vocab_size))
    rng = np.random.default_rng(11)
    flat = T.flat_params(step_params)
    grads = {f"g.{p}": (rng.normal(size=(2,) + flat[p].shape)
                        * np.array([1.0, 10.0])[(slice(None),) + (None,)
                                                * flat[p].ndim])
             .astype(np.float32) for p in PAYLOAD_LEAVES}
    inputs = tmp / "inputs.npz"
    np.savez(inputs, tokens=toks[:, :-1].copy(), labels=toks[:, 1:].copy(),
             **weights, **grads)

    # the reference's tp=2 checkpoint: params from another key, moments
    # drawn at random
    ck = jinit(jax.random.key(2), jcfg, TP)
    leaves, tree = jax.tree.flatten(ck)
    keys = jax.random.split(jax.random.key(3), 2 * len(leaves))
    mu = jax.tree.unflatten(tree, [jax.random.normal(k, l.shape)
                                   for k, l in zip(keys[::2], leaves)])
    nu = jax.tree.unflatten(tree, [jnp.abs(jax.random.normal(k, l.shape))
                                   for k, l in zip(keys[1::2], leaves)])
    jckpt.save(JState(jnp.asarray(5, jnp.int32), ck, mu, nu, None),
               str(tmp / "ref_ckpt"), 5)

    extra = {"archs": list(T.ARCHS), "ckpt_ref_dir": str(tmp / "ref_ckpt"),
             "payload_leaves": list(PAYLOAD_LEAVES)}
    runs = {}
    for name, mesh, cases in (
            ("w12", (1, 2), ["forward", "ckpt"]),
            ("w22", (2, 2), ["steps", "payloads", "ckpt"]),
            ("w32", (3, 2), ["zero1_fault"])):
        runs[name] = T.spawn_world(tmp, name, mesh, cases, inputs,
                                   ckpt_port_dir=str(tmp / f"port_{name}"),
                                   **extra)
    ref_out = tmp / "ref.npz"
    code = (f"import sys\nsys.argv = ['ref', {str(inputs)!r}, "
            f"{str(ref_out)!r}, {','.join(PAYLOAD_LEAVES)!r}]\n" + _STEPS)
    with ThreadPoolExecutor(1) as pool:    # beside the reference's forwards
        steps = pool.submit(devices4, code, timeout=400)
        refs = {arch: T.reference(arch, TP)[1] for arch in T.ARCHS}
        assert "STEPS-OK" in steps.result()
    errors = {}
    for name, (_, _, wait) in runs.items():
        errors.update(wait())
    return SimpleNamespace(tmp=tmp, runs=runs, errors=errors, refs=refs,
                           ref=dict(np.load(ref_out)), ckpt=(ck, mu, nu),
                           inputs=dict(np.load(inputs)))


def _case(w, world, case, rank):
    return T.case(w.runs[world][0], w.errors, case, rank)


# ---- tp = 2: every arch ---------------------------------------------------------

@pytest.mark.parametrize("arch", T.ARCHS)
def test_tp2_matches_the_reference(worlds, arch):
    T.hold_forward(_case(worlds, "w12", "forward", 0), arch,
                   worlds.refs[arch])


@pytest.mark.parametrize("arch", T.ARCHS)
def test_tp2_each_rank_holds_its_pieces(worlds, arch):
    for rank in range(2):
        T.hold_pieces(_case(worlds, "w12", "forward", rank), arch, TP)


# ---- the (2, 2) steps ------------------------------------------------------------

def _stacked(got, prefix):
    """The port's whole per-layer arrays under ``prefix`` stacked into the
    reference's leaves."""
    cfg = configs.reduced_config(ARCH)
    paths = reference_paths(Transformer(cfg, tp=TP, device="meta"))
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


def _hold_moment(got, want, tag, what):
    assert sorted(got) == sorted(want), what
    tol = R.GRAD_TOL * (2 if tag == "nu" else 1)
    for k in want:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= tol, (what, k, err)


def test_local_accum_step_at_2x2_matches_the_reference(worlds):
    got = _case(worlds, "w22", "steps", 0)
    port, want = _stacked(got, "local.p."), _ref(worlds, "local.p.")
    assert sorted(port) == sorted(want)
    for k in want:
        np.testing.assert_allclose(port[k], want[k], err_msg=k, **LOCAL_TOL)
    for tag in ("mu", "nu"):
        _hold_moment(_stacked(got, f"local.{tag}."),
                     _ref(worlds, f"local.{tag}."), tag, f"local {tag}")
    np.testing.assert_allclose(got["local.loss"], worlds.ref["local.loss"],
                               rtol=R.TRAIN_RTOL)
    np.testing.assert_allclose(got["local.grad_norm"],
                               worlds.ref["local.grad_norm"],
                               rtol=5 * R.TRAIN_RTOL)


def test_zero1_step_at_2x2_matches_the_reference(worlds):
    got = _case(worlds, "w22", "steps", 0)
    port, want = _stacked(got, "zero1.p."), _ref(worlds, "zero1.p.")
    for k in want:
        np.testing.assert_allclose(port[k], want[k], err_msg=k, **ZERO1_TOL)
    np.testing.assert_allclose(got["zero1.loss"], worlds.ref["zero1.loss"],
                               rtol=R.TRAIN_RTOL)
    np.testing.assert_allclose(got["zero1.grad_norm"],
                               worlds.ref["zero1.grad_norm"],
                               rtol=5 * R.TRAIN_RTOL)
    for tag in ("mu", "nu"):
        mine = {k[len(f"zero1.{tag}."):]: v for k, v in got.items()
                if k.startswith(f"zero1.{tag}.")}
        ref = _ref(worlds, f"zero1.{tag}.")
        for k, v in mine.items():
            assert v.shape == ref[k].shape, (tag, k, v.shape, ref[k].shape)
        _hold_moment(mine, ref, tag, f"zero1 {tag}")


@pytest.mark.parametrize("rank", range(4))
def test_zero1_moments_split_over_data_and_model(worlds, rank):
    """Rank ``r`` at ``(d, m) = divmod(r, 2)`` holds block ``[d, m c/2 :
    (m + 1) c/2]`` of each ``(2, c)`` moment, and the same whole params
    as every other rank."""
    first = _case(worlds, "w22", "steps", 0)
    got = _case(worlds, "w22", "steps", rank)
    d, m = divmod(rank, 2)
    for key, v in got.items():
        if key.startswith("zero1.mu_local."):
            full = first["zero1.mu." + key[len("zero1.mu_local."):]]
            c = full.shape[1] // 2
            assert np.array_equal(v, full[d:d + 1, m * c:(m + 1) * c]), key
        if key.startswith(("zero1.p.", "local.p.")):
            assert np.array_equal(v, first[key]), (rank, key)


def test_int8_step_at_2x2_loss_falls(worlds):
    losses = _case(worlds, "w22", "steps", 0)["int8.losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("rank", range(4))
def test_int8_payloads_at_2x2_are_the_references(worlds, rank):
    """The step's reduction of a leaf gathered over ``"model"``: the same
    int8 payloads, scales and sum as the reference's
    ``compressed_allreduce`` of the whole leaf over the data axis."""
    got, ref = _case(worlds, "w22", "payloads", rank), worlds.ref
    d = rank // 2
    for path in PAYLOAD_LEAVES:
        for key in ("q_send", "s_send", "q_sum", "s_sum"):
            a, b = got[f"{path}.{key}"], ref[f"{path}.{key}{d}"]
            assert a.dtype == b.dtype and np.array_equal(a, b), (path, key)
        y = got[f"{path}.y"]
        want = ref[f"{path}.y"][d]
        y = y if path.startswith("seg") else y[0]
        assert np.array_equal(y, want), (path, np.abs(y - want).max(),
                                         np.abs(want).max())


# ---- checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("world,rank", [("w12", 0), ("w12", 1), ("w22", 0),
                                        ("w22", 1), ("w22", 2), ("w22", 3)])
def test_a_reference_tp2_checkpoint_restores_into_the_pieces(worlds, world,
                                                             rank):
    got = _case(worlds, world, "ckpt", rank)
    assert got["step"].tolist() == [5, 5]
    cfg = configs.reduced_config(ARCH)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           mesh=torch.empty(1 if world == "w12" else 2, TP))
    model = Transformer(cfg, tp=TP, device="meta")
    lay = tpar.model_layouts(model, cfg, mesh)
    paths = reference_paths(model)
    ck, mu, nu = worlds.ckpt
    m = rank % TP
    for tag, tree in (("p", ck), ("mu", mu), ("nu", nu)):
        leaves = T.flat_params(tree)
        for name, (path, j) in paths.items():
            whole = torch.from_numpy(np.array(R.at(leaves, path, j)))
            want = tpar.take(whole, lay[name], m, TP).numpy()
            assert np.array_equal(got[f"{tag}.{name}"], want), (tag, name)
    assert got["reshard_equal"].all()
    assert got["loss"] == got["reshard_loss"] and np.isfinite(got["loss"])


@pytest.mark.parametrize("world", ["w12", "w22"])
def test_a_port_tp2_checkpoint_restores_in_the_reference(worlds, world):
    jcfg = jreduced(ARCH)
    ap = abstract_params(jcfg, TP)
    abstract = JState(jax.ShapeDtypeStruct((), jnp.int32), ap, ap, ap, None)
    js, at = jckpt.restore(abstract, str(worlds.tmp / f"port_{world}"))
    assert at == 5 and int(js.step) == 5
    for mine, want in zip((js.params, js.mu, js.nu), worlds.ckpt):
        a, b = T.flat_params(mine), T.flat_params(want)
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.array_equal(a[k], b[k]), k


def test_zero1_where_the_reference_cannot_trace_raises_value_error(worlds):
    """``n_dp = 3, tp = 2``: no leaf size of the reduced phi4-mini is a
    multiple of 3, so a moment row (``ceil(P / 6) * 2``) can outgrow the
    gradient shard (``ceil(P / 3)``); the reference's step does not trace
    there (``tests/test_torch_dp_train.py``) and the port's raises."""
    for rank in range(6):
        err = str(_case(worlds, "w32", "zero1_fault", rank)["error"])
        assert "zero1 moments of" in err and "gradient shard" in err, err
