"""The port's FSDP execution held against the JAX package's GSPMD step on
the CPU (``tests/torch_fsdp_world.py``'s gloo worlds beside the reference
on 4 forced host devices, ``devices4``).

* ``(2, 1)`` and ``(2, 2)`` worlds run every reduced arch's
  ``make_train_step(..., mesh=...)`` at ``fsdp=True``, two steps of
  ``accum_steps=2``, the bf16 state for ``BF16_STATE_ARCHS``, from the
  reference's weights; the reference runs its jitted ``make_train_step``
  with the state placed by ``param_shardings(fsdp=True)`` /
  ``moment_shardings`` on a ``(2, 2)`` mesh (one function: the ``(2, 1)``
  world is held against it too).  Losses at ``TRAIN_RTOL``, gradient
  norms at five times it; parameters within ``PARAM_TOL``.  The first
  step's moments (its gradients) are no further from the reference's
  than the single-card step's run of the same weights is, plus
  ``GRAD_TOL`` of each leaf's largest magnitude (twice that for ``nu``;
  ``_hold_beside``), and within ``SINGLE_FIRST_TOL`` of that run's, the
  first loss within ``SINGLE_RTOL`` of its.  The second step's moments
  are within ``MOMENT_TOL`` (twice that for ``nu``) of the reference's:
  Adam's first update is about ``lr * sign(g)``, so an element whose
  gradient is near 0 steps either way, and the second step's gradients
  (and an MoE's routing, which a bf16 router flips) follow; the
  single-card run differs from the reference by as much there (up to
  0.215 of a leaf, the reduced llama4's ``moe.w_in``), while the FSDP
  run's first step stays within 0.037 of the single-card run's.  Each
  rank's parameter and moment pieces have the shapes of the reference's
  *input* shardings (``NamedSharding.shard_shape``; the jit lays its
  outputs out by XLA's own choice).
* At a batch of 4 x 16 every rank's tokens are fewer than the reduced
  MoE's ``group_size`` (64), so a routing group spans the data ranks;
  ``mixtral-8x22b@64`` runs 4 x 64, where each rank's rows are one whole
  group.
* Prefill and greedy decode at ``fsdp=True`` on ``(2, 1)`` give the
  unsharded run's tokens; autograd keeps no whole layer leaf under
  ``remat="full"``.
* The reference's ``fsdp=True`` checkpoint of a bf16 state with f32
  moments restores into each rank's pieces bitwise and steps as the
  reference's step does; the port's checkpoint of the stepped state
  restores in the reference bitwise.
* ``build_cell`` picks the reference's ``fsdp``, state dtype and
  ``accum`` and builds the reference's batch shapes.
* The optimizer's bf16 sequence on one process equals the reference's
  ``clip_by_global_norm`` / ``adamw_update`` run op by op bitwise, given
  one norm; the compiled reference fuses the update (XLA contracts and
  reorders its f32 arithmetic), and there the moments agree to
  ``COMPILED_RTOL``.
"""
import json
import types
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fsdp_world as W
import torch_tp_ref as T
import torch_train_ref as R
from repro.checkpoint import io as jckpt
from repro.configs import BF16_STATE_ARCHS as JBF16
from repro.configs import FSDP_ARCHS as JFSDP
from repro.configs import reduced_config as jreduced
from repro.launch import shapes as jshapes
from repro.models import abstract_params
from repro.models import init_params as jinit
from repro.train import optimizer as JO
from repro.train.state import TrainState as JState
from repro_torch import configs
from repro_torch.models.transformer import Transformer, reference_paths
from repro_torch.train import optimizer as PO

ARCHS = T.ARCHS
GROUP_ARCH = "mixtral-8x22b@64"
RUNS = ARCHS + (GROUP_ARCH,)
MESHES = {"w21": (2, 1), "w22": (2, 2)}
BATCH, SEQ = 4, 16
PARAM_TOL = dict(rtol=1e-2, atol=5e-3)
SINGLE_RTOL = 1e-4
SINGLE_FIRST_TOL = 0.05
MOMENT_TOL = 0.3
SERVE_TOL = 2e-2
COMPILED_RTOL = 1e-6

_REF = r"""
import sys
import numpy as np, jax, jax.numpy as jnp, ml_dtypes
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.core.compat import make_mesh
from repro.checkpoint import io as jckpt
from repro.configs import reduced_config, BF16_STATE_ARCHS
from repro.distributed import sharding as shd
from repro.models import abstract_params
from repro.train.optimizer import OptimizerConfig
from repro.train.state import TrainState, abstract_state
from repro.train.step import make_train_step

inp, out, runs, ckpt_dir, ckpt_arch = sys.argv[1:6]
z = dict(np.load(inp))
oc = OptimizerConfig(**{OC})
mesh22 = make_mesh((2, 2), ("data", "model"))
mesh21 = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
res = {{}}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        res[prefix + key] = np.asarray(jnp.asarray(leaf, jnp.float32))

def tree_of(prefix, bf16):
    params = {{}}
    for key, v in z.items():
        if key.startswith(prefix):
            *parents, leaf = key[len(prefix):].split(".")
            node = params
            for p in parents:
                node = node.setdefault(p, {{}})
            node[leaf] = jnp.asarray(v, jnp.bfloat16 if bf16 else jnp.float32)
    return params

def placed(cfg, params):
    pshard = shd.param_shardings(params, cfg, mesh22, fsdp=True)
    mshard = shd.moment_shardings(params, pshard, mesh22)
    rep = NamedSharding(mesh22, P())
    return TrainState(rep, pshard, mshard, mshard, None)

def step_of(cfg, sshard, batch):
    bshard = shd.batch_shardings(mesh22, batch)
    return jax.jit(make_train_step(cfg, oc, tp=2, accum_steps={ACCUM}),
                   in_shardings=(sshard, bshard)), jax.device_put(batch,
                                                                  bshard)

for run in runs.split(","):
    arch = run.split("@")[0]
    cfg = reduced_config(arch)
    params = tree_of(f"w.{{arch}}.", arch in BF16_STATE_ARCHS)
    state = TrainState(jnp.zeros((), jnp.int32), params,
                       jax.tree.map(jnp.zeros_like, params),
                       jax.tree.map(jnp.zeros_like, params), None)
    sshard = placed(cfg, params)
    batch = {{k[len(f"b.{{run}}."):]: jnp.asarray(v) for k, v in z.items()
              if k.startswith(f"b.{{run}}.")}}
    step, batch = step_of(cfg, sshard, batch)
    for i in range({STEPS}):
        state, m = step(jax.device_put(state, sshard), batch)
        res[f"{{run}}.loss{{i}}"] = float(m["loss"])
        res[f"{{run}}.grad_norm{{i}}"] = float(m["grad_norm"])
        res[f"{{run}}.dtypes{{i}}"] = np.array(",".join(sorted(
            {{str(l.dtype) for l in jax.tree.leaves((state.mu, state.nu))}})))
        if i == 0:
            put(f"{{run}}.mu1.", state.mu); put(f"{{run}}.nu1.", state.nu)
    res[f"{{run}}.param_dtype"] = np.array(str(
        jax.tree.leaves(state.params)[0].dtype))
    put(f"{{run}}.p.", state.params); put(f"{{run}}.mu.", state.mu)
    put(f"{{run}}.nu.", state.nu)
    if "@" in run:
        continue
    for name, mesh in (("w22", mesh22), ("w21", mesh21)):
        ps = shd.param_shardings(params, cfg, mesh, fsdp=True)
        ms = shd.moment_shardings(params, ps, mesh)
        for tag, tree in (("p", ps), ("m", ms)):
            for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = ".".join(str(getattr(k, "key", k)) for k in path)
                leaf = params
                for k in key.split("."):
                    leaf = leaf[k]
                res[f"{{run}}.{{name}}.shape.{{tag}}.{{key}}"] = np.array(
                    sh.shard_shape(leaf.shape))

# the checkpoint: restored (bf16 leaves come back as raw V2 words), placed
# by the fsdp=True shardings and stepped once
if not ckpt_arch:
    np.savez(out, **res)
    print("REF-OK")
    sys.exit(0)
cfg = reduced_config(ckpt_arch)
ap = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, jnp.bfloat16),
                  abstract_params(cfg, 2))
st, at = jckpt.restore(abstract_state(ap), ckpt_dir)
fix = lambda a: a.view(ml_dtypes.bfloat16) if a.dtype.kind == "V" else a
st = jax.tree.map(lambda a: jnp.asarray(fix(np.asarray(a))), st)
batch = {{k[len(f"b.{{ckpt_arch}}."):]: jnp.asarray(v) for k, v in z.items()
          if k.startswith(f"b.{{ckpt_arch}}.")}}
sshard = placed(cfg, st.params)
step, batch = step_of(cfg, sshard, batch)
st, m = step(jax.device_put(st, sshard), batch)
res["ckpt.loss"] = float(m["loss"])
put("ckpt.p.", st.params); put("ckpt.mu.", st.mu); put("ckpt.nu.", st.nu)
np.savez(out, **res)
print("REF-OK")
""".format(OC=W.OC, ACCUM=W.ACCUM, STEPS=W.STEPS)


def _batch(run):
    arch, _, seq = run.partition("@")
    return T.W.kind_batch(configs.reduced_config(arch), b=BATCH,
                          s=int(seq or SEQ))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, devices4):
    """Every run once: the ``(2, 1)`` and ``(2, 2)`` worlds beside the
    reference's GSPMD steps."""
    tmp = tmp_path_factory.mktemp("fsdp")
    weights = {}
    for arch in ARCHS:
        jp = jinit(jax.random.key(T.SEED), jreduced(arch), 2)
        weights.update({f"w.{arch}.{k}": v
                        for k, v in T.flat_params(jp).items()})
    batches = {f"b.{run}.{k}": v for run in RUNS
               for k, v in _batch(run).items()}
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **weights, **batches)

    # the reference's fsdp=True checkpoint: a bf16 state of the reduced
    # mixtral with f32 moments (as after its first step)
    jcfg = jreduced(W.CKPT_ARCH)
    ck = jax.tree.map(lambda l: l.astype(jnp.bfloat16),
                      jinit(jax.random.key(2), jcfg, 2))
    leaves, tree = jax.tree.flatten(ck)
    keys = jax.random.split(jax.random.key(3), 2 * len(leaves))
    mu = jax.tree.unflatten(tree, [jax.random.normal(k, l.shape) * 1e-2
                                   for k, l in zip(keys[::2], leaves)])
    nu = jax.tree.unflatten(tree, [jnp.abs(jax.random.normal(k, l.shape))
                                   * 1e-4 for k, l in zip(keys[1::2],
                                                          leaves)])
    jckpt.save(JState(jnp.asarray(5, jnp.int32), ck, mu, nu, None),
               str(tmp / "ref_ckpt"), 5)

    runs = {}
    extra = {"archs": list(RUNS), "ckpt_ref_dir": str(tmp / "ref_ckpt")}
    for name, cases in (("w21", ["steps", "serve", "saved", "launch"]),
                        ("w22", ["steps", "ckpt", "launch"])):
        runs[name] = T.spawn_world(tmp, name, MESHES[name], cases, inputs,
                                   script="torch_fsdp_world.py",
                                   ckpt_port_dir=str(tmp / f"port_{name}"),
                                   **extra)
    # two reference processes of about equal compile time
    slow = ("mixtral-8x22b", "llama4-maverick-400b-a17b",
            "llama-3.2-vision-11b", "falcon-mamba-7b", GROUP_ARCH)
    halves = [([r for r in RUNS if r not in slow], W.CKPT_ARCH),
              (list(slow), "")]
    outs = [tmp / f"ref{i}.npz" for i in range(len(halves))]
    codes = [(f"import sys\nsys.argv = ['ref', {str(inputs)!r}, "
              f"{str(out)!r}, {','.join(part)!r}, "
              f"{str(tmp / 'ref_ckpt')!r}, {ck_arch!r}]\n" + _REF)
             for out, (part, ck_arch) in zip(outs, halves)]
    with ThreadPoolExecutor(len(codes)) as pool:
        for done in list(pool.map(lambda c: devices4(c, timeout=500),
                                  codes)):
            assert "REF-OK" in done
    errors = {}
    for name, (_, _, wait) in runs.items():
        errors.update(wait())
    ref = {}
    for out in outs:
        ref.update(np.load(out))
    return SimpleNamespace(tmp=tmp, runs=runs, errors=errors, ref=ref,
                           ckpt=(ck, mu, nu), loaded={})


def _case(w, world, case, rank):
    failed = {k: v[-3000:] for k, v in w.errors.items()
              if k.endswith(f"/{case}")}
    assert not failed, next(iter(failed.items()))
    key = (world, case, rank)
    if key not in w.loaded:
        w.loaded[key] = dict(np.load(w.runs[world][0] / f"{case}_{rank}.npz"))
    return w.loaded[key]


def _stacked(got, prefix, arch):
    """The port's whole per-layer arrays under ``prefix`` stacked into the
    reference's leaves."""
    cfg = configs.reduced_config(arch)
    stacked = {}
    for name, (path, j) in reference_paths(
            Transformer(cfg, device="meta")).items():
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


def _hold_beside(got, single, want, tol, what):
    """Each leaf of ``got`` no further from the reference's ``want`` (in
    units of the leaf's largest magnitude) than the single-card step's
    ``single`` is, plus ``tol``: against the compiled reference the
    single-card step already differs by up to a third of a leaf where an
    MoE's bf16 router flips a token's expert (the reduced llama4's first
    step) and by several percent elsewhere, and FSDP must add no more."""
    assert sorted(got) == sorted(want), what
    for k in want:
        scale = np.abs(want[k]).max()
        mine = np.abs(got[k] - want[k]).max() / scale
        base = np.abs(single[k] - want[k]).max() / scale
        assert mine <= base + tol, (what, k, mine, base)


def _hold_moment(got, want, tag, what, tol):
    assert sorted(got) == sorted(want), what
    tol = tol * (2 if tag == "nu" else 1)
    for k in want:
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= tol, (what, k, err)


# ---- the steps -------------------------------------------------------------------

@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("run", RUNS)
def test_fsdp_step_matches_the_reference(worlds, run, world):
    got = _case(worlds, world, "steps", 0)
    arch = run.split("@")[0]
    for i in range(W.STEPS):
        np.testing.assert_allclose(got[f"{run}.losses"][i],
                                   worlds.ref[f"{run}.loss{i}"],
                                   rtol=R.TRAIN_RTOL, err_msg=f"loss {i}")
        np.testing.assert_allclose(got[f"{run}.grad_norms"][i],
                                   worlds.ref[f"{run}.grad_norm{i}"],
                                   rtol=5 * R.TRAIN_RTOL,
                                   err_msg=f"grad norm {i}")
    port, want = _stacked(got, f"{run}.p.", arch), _ref(worlds, f"{run}.p.")
    assert sorted(port) == sorted(want)
    for k in want:
        np.testing.assert_allclose(port[k], want[k], err_msg=k, **PARAM_TOL)
    for tag in ("mu", "nu"):
        want = _ref(worlds, f"{run}.{tag}1.")
        _hold_beside(_stacked(got, f"{run}.{tag}1.", arch),
                     _stacked(got, f"{run}.single.{tag}1.", arch), want,
                     R.GRAD_TOL * (2 if tag == "nu" else 1),
                     f"{run} {tag}1")
        _hold_moment(_stacked(got, f"{run}.{tag}.", arch),
                     _ref(worlds, f"{run}.{tag}."), tag, f"{run} {tag}",
                     MOMENT_TOL)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("run", RUNS)
def test_fsdp_step_matches_the_single_card_step(worlds, run, world):
    """The same two steps on one process (``make_train_step`` without a
    mesh) from the same weights: what FSDP changes is the order of the
    sums over the ranks (and, at ``(2, 2)``, tensor parallelism's)."""
    got = _case(worlds, world, "steps", 0)
    np.testing.assert_allclose(got[f"{run}.losses"][0],
                               got[f"{run}.single.loss0"], rtol=SINGLE_RTOL)
    np.testing.assert_allclose(got[f"{run}.losses"][1],
                               got[f"{run}.single.loss1"],
                               rtol=R.TRAIN_RTOL)
    names = [k[len(f"{run}.single.p."):] for k in got
             if k.startswith(f"{run}.single.p.")]
    for name in names:
        np.testing.assert_allclose(got[f"{run}.p.{name}"],
                                   got[f"{run}.single.p.{name}"],
                                   err_msg=name, **PARAM_TOL)
    for tag in ("mu1", "nu1"):
        _hold_moment({n: got[f"{run}.{tag}.{n}"] for n in names},
                     {n: got[f"{run}.single.{tag}.{n}"] for n in names},
                     tag[:2], f"{run} {tag}", SINGLE_FIRST_TOL)


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_the_reference_s_input_shard_shapes(worlds, arch,
                                                            world):
    """A per-layer piece is the stacked leaf's shard without its layer
    dim; where ZeRO-1 puts the data axes on the layer dim the port keeps
    the layer's moment whole over them (ROADMAP, Carried notes), which is
    what the shard's other dims say."""
    cfg = configs.reduced_config(arch)
    paths = reference_paths(Transformer(cfg, device="meta"))
    for rank in range(np.prod(MESHES[world])):
        got = _case(worlds, world, "steps", rank)
        for tag in ("p", "m"):
            for name, (path, j) in paths.items():
                want = worlds.ref[f"{arch}.{world}.shape.{tag}.{path}"]
                want = want if j is None else want[1:]
                assert list(got[f"{arch}.shape.{tag}.{name}"]) == \
                    list(want), (rank, tag, name)
        assert bool(got[f"{arch}.gather_equal"]), rank


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.BF16_STATE_ARCHS))
def test_a_bf16_state_s_moments_turn_f32_as_the_reference_s(worlds, arch,
                                                            world):
    assert arch in JBF16
    got = _case(worlds, world, "steps", 0)
    assert str(got[f"{arch}.param_dtype"]) == "torch.bfloat16"
    assert str(worlds.ref[f"{arch}.param_dtype"]) == "bfloat16"
    for i in range(W.STEPS):
        assert str(worlds.ref[f"{arch}.dtypes{i}"]) == "float32"
        assert str(got[f"{arch}.moment_dtypes"][i]) == "torch.float32"


def test_the_moe_runs_cover_groups_across_and_within_ranks():
    """At ``BATCH x SEQ`` each rank's microbatch tokens are fewer than the
    group, so a group spans the ranks; at ``GROUP_ARCH`` they are one
    whole group."""
    for run, spans in (("mixtral-8x22b", True), ("llama4-maverick-400b-a17b",
                                                 True), (GROUP_ARCH, False)):
        arch, _, seq = run.partition("@")
        m = configs.reduced_config(arch).moe
        tokens = BATCH // W.ACCUM // 2 * int(seq or SEQ)
        gs = min(m.group_size, 2 * tokens)
        assert bool(tokens % gs) == spans, run


# ---- serving and memory ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_prefill_and_decode_give_the_unsharded_tokens(worlds, arch):
    for rank in range(2):
        got = _case(worlds, "w21", "serve", rank)
        assert np.array_equal(got[f"{arch}.fsdp.tokens"],
                              got[f"{arch}.whole.tokens"]), rank
        np.testing.assert_allclose(got[f"{arch}.fsdp.logits"],
                                   got[f"{arch}.whole.logits"],
                                   rtol=SERVE_TOL, atol=SERVE_TOL)
        rows = got[f"{arch}.fsdp.cache_rows"]
        assert (rows == W.SERVE_BATCH // 2).all(), rows


def test_no_whole_layer_leaf_outlives_its_layer(worlds):
    """Under ``remat="full"``, with the cyclic collector off: every layer
    leaf gathered in the forward is gone when it ends (a reference cycle
    through the layer's view held them all, 10 GB a rank at mixtral's
    full width), and none is saved for the backward."""
    for rank in range(2):
        got = _case(worlds, "w21", "saved", rank)
        assert got["fsdp.gathered"] > 0 and got["fsdp.alive"] == 0, got
        assert got["fsdp.whole_leaves"].size == 0, got["fsdp.whole_leaves"]
        assert got["fsdp.saved_bytes"] <= got["whole.saved_bytes"]


# ---- checkpoints -----------------------------------------------------------------

@pytest.mark.parametrize("rank", range(4))
def test_a_reference_fsdp_checkpoint_restores_into_the_pieces(worlds, rank):
    """Rank ``r`` at ``(d, m) = divmod(r, 2)`` holds the reference leaf's
    model piece ``m`` cut to data piece ``d`` where the placements cut it
    over ``"data"`` (a moment: its parameter's FSDP piece, or ZeRO-1's
    slice), bitwise, bf16 params and f32 moments; one step on it matches
    the reference's."""
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.sharding import (moment_placements,
                                                  param_placements)
    got = _case(worlds, "w22", "ckpt", rank)
    assert got["step"].tolist() == [5, 5]
    cfg = configs.reduced_config(W.CKPT_ARCH)
    model = Transformer(cfg, tp=2, device="meta")
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           mesh=torch.empty(2, 2))
    lay = tpar.model_layouts(model, cfg, mesh, fsdp=True)
    pl = {"p": param_placements(model, cfg, mesh, fsdp=True),
          "mu": moment_placements(model, cfg, mesh, fsdp=True)}
    pl["nu"] = pl["mu"]
    d, m = divmod(rank, 2)
    ck, mu, nu = worlds.ckpt
    for tag, tree in (("p", ck), ("mu", mu), ("nu", nu)):
        leaves = {k: np.asarray(jnp.asarray(v, jnp.float32))
                  for k, v in R.flat(tree).items()}
        for name, (path, j) in reference_paths(model).items():
            whole = torch.from_numpy(np.array(R.at(leaves, path, j)))
            want = tpar.take(whole, lay[name], m, 2)
            data = pl[tag][name][0]         # the "data" axis's placement
            if data.is_shard():
                want = want.chunk(2, dim=data.dim)[d]
            assert np.array_equal(got[f"piece.{tag}.{name}"],
                                  want.numpy()), (tag, name)
            dtype = "torch.bfloat16" if tag == "p" else "torch.float32"
            assert str(got[f"dtype.{tag}.{name}"]) == dtype
    np.testing.assert_allclose(got["loss"], worlds.ref["ckpt.loss"],
                               rtol=R.TRAIN_RTOL)
    port = _stacked(got, "p.", W.CKPT_ARCH)
    want = _ref(worlds, "ckpt.p.")
    for k in want:
        np.testing.assert_allclose(port[k], want[k], err_msg=k, **PARAM_TOL)
    for tag in ("mu", "nu"):
        _hold_moment(_stacked(got, f"{tag}.", W.CKPT_ARCH),
                     _ref(worlds, f"ckpt.{tag}."), tag, f"ckpt {tag}",
                     R.GRAD_TOL)


def test_a_port_fsdp_checkpoint_restores_bitwise_in_the_reference(worlds):
    """The reference reads the port's bf16 leaves as its own ``np.save``
    writes them (``<V2`` words) and its moments as f32."""
    jcfg = jreduced(W.CKPT_ARCH)
    ap = abstract_params(jcfg, 2)
    abstract = JState(jax.ShapeDtypeStruct((), jnp.int32), ap, ap, ap, None)
    js, at = jckpt.restore(abstract, str(worlds.tmp / "port_w22"))
    assert at == 6 and int(js.step) == 6
    got = _case(worlds, "w22", "ckpt", 0)
    cfg = configs.reduced_config(W.CKPT_ARCH)
    paths = reference_paths(Transformer(cfg, tp=2, device="meta"))
    leaves = R.flat(js.params)
    bits = {}
    for name, (path, j) in paths.items():
        arr = R.at(leaves, path, j)
        assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2, path
        bits[name] = np.asarray(arr).view(np.int16)
        assert np.array_equal(bits[name], got[f"bits.p.{name}"]), name
    manifest = json.loads((worlds.tmp / "port_w22" / "step_00000006" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["1.embed"]["dtype"] == "bfloat16"
    with open(worlds.tmp / "port_w22" / "step_00000006" / "1.embed.npy",
              "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    for tag, tree in (("mu", js.mu), ("nu", js.nu)):
        flat = R.flat(tree)
        for name, (path, j) in paths.items():
            arr = R.at(flat, path, j)
            assert arr.dtype == np.float32, (tag, path)
            assert np.array_equal(arr, got[f"{tag}.{name}"]), (tag, name)


# ---- build_cell ------------------------------------------------------------------

def _reference_mesh(shape):
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)))


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_build_cell_takes_the_reference_s_defaults(worlds, arch, world):
    got = _case(worlds, world, "launch", 0)
    jcfg = jreduced(arch)
    for shape, sc in jshapes.SHAPES.items():
        key = f"{arch}.{shape}"
        assert bool(got[f"{key}.fsdp"]) == (arch in JFSDP)
        # the norms: bf16 in a bf16-state arch's cell, else f32 (a
        # serving model's matrices alone are bf16)
        want = "torch.bfloat16" if arch in JBF16 else "torch.float32"
        assert str(got[f"{key}.dtype"]) == want, key
        accum = jshapes.default_accum(jcfg, shape,
                                      _reference_mesh(MESHES[world]))
        assert int(got[f"{key}.accum"]) == accum, key
        for k, v in jshapes.input_specs(jcfg, shape).items():
            assert list(got[f"{key}.batch.{k}"]) == \
                [str(n) for n in v.shape] + [f"torch.{v.dtype}"], (key, k)


# ---- the optimizer's bf16 sequence ---------------------------------------------

_SHAPES = {"layers.0.attn.wq": (64, 4, 16), "layers.0.norm1": (64,),
           "final_norm": (64,), "embed": (256, 64)}


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {"p": {k: rng.normal(size=s) for k, s in _SHAPES.items()},
            "g": {k: rng.normal(size=s) * 3 for k, s in _SHAPES.items()},
            "m": {k: rng.normal(size=s) * 0.1 for k, s in _SHAPES.items()},
            "v": {k: np.abs(rng.normal(size=s)) * 0.01
                  for k, s in _SHAPES.items()}}


def _stack(k, x):
    """The reference's leaf: a layer's parameter carries the stacked axis
    (its rank decides the weight decay)."""
    return x[None] if k.startswith("layers.") else x


@pytest.mark.parametrize("grad,moment", [("bfloat16", "bfloat16"),
                                         ("bfloat16", "float32"),
                                         ("float32", "bfloat16"),
                                         ("float32", "float32")])
def test_the_bf16_optimizer_sequence_is_the_reference_s(grad, moment):
    """bf16 parameters with gradients and moments of each dtype: given the
    reference's norm, the clip and the update equal its op-by-op run
    bitwise, the moments f32.  The compiled reference keeps ``b1 * m`` of
    a bf16 moment in f32 (XLA drops that rounding) and reorders the f32
    arithmetic: its parameters are within a bf16 rounding and the
    learning rate (the update's size) of the port's, its moments within ``COMPILED_RTOL`` of each leaf's largest magnitude
    (``2 ** -8`` of it, one bf16 rounding, from bf16 moments)."""
    oc = dict(lr=1e-3, warmup_steps=1, decay_steps=50)
    x = _leaves(0)
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def jax_tree(tag, dt):
        return {k: jnp.asarray(_stack(k, v), dt) for k, v in x[tag].items()}

    def torch_tree(tag, dt):
        return {k: torch.from_numpy(np.asarray(jnp.asarray(
            v, jdt[dt]).astype(jnp.float32))).to(tdt[dt])
            for k, v in x[tag].items()}

    step = 3

    def ref(jp, jg, jm, jv):
        g2, n = JO.clip_by_global_norm(jg, 1.0)
        p, m, v, lr = JO.adamw_update(jp, g2, jm, jv, jnp.asarray(
            step, jnp.int32), JO.OptimizerConfig(**oc))
        return p, m, v, n
    args = (jax_tree("p", jnp.bfloat16), jax_tree("g", jdt[grad]),
            jax_tree("m", jdt[moment]), jax_tree("v", jdt[moment]))
    with jax.disable_jit():
        eager = ref(*args)
    compiled = jax.jit(ref)(*args)

    pg = torch_tree("g", grad)
    norm = PO.global_norm(pg.values())
    np.testing.assert_allclose(float(norm), float(eager[3]), rtol=1e-6)
    PO.scale_grads(pg, torch.tensor(float(eager[3])), 1.0)
    pp, pm, pv = (torch_tree("p", "bfloat16"), torch_tree("m", moment),
                  torch_tree("v", moment))
    _, pm, pv, _ = PO.adamw_update(pp, pg, pm, pv,
                                   torch.tensor(step, dtype=torch.int32),
                                   PO.OptimizerConfig(**oc))

    def arr(t, s):
        return np.asarray(jnp.asarray(t, jnp.float32)).reshape(s)
    for k, s in _SHAPES.items():
        assert pp[k].dtype == torch.bfloat16
        assert pm[k].dtype == pv[k].dtype == torch.float32
        for got, e, what in ((pp[k].float(), eager[0][k], "p"),
                             (pm[k], eager[1][k], "mu"),
                             (pv[k], eager[2][k], "nu")):
            assert np.array_equal(got.numpy(), arr(e, s)), (k, what)
    for k, s in _SHAPES.items():
        np.testing.assert_allclose(pp[k].float().numpy(),
                                   arr(compiled[0][k], s), rtol=2 ** -7,
                                   atol=oc["lr"], err_msg=k)
        tol = 2 ** -8 if moment == "bfloat16" else COMPILED_RTOL
        for got, c, what in ((pm[k], compiled[1][k], "mu"),
                             (pv[k], compiled[2][k], "nu")):
            c = arr(c, s)
            err = np.abs(got.numpy() - c).max() / np.abs(c).max()
            assert err <= tol, (k, what, err)


def test_an_f32_state_keeps_the_in_place_path():
    """All-f32 leaves: the moments stay the same tensors, updated in
    place, as before the bf16 sequence existed."""
    x = _leaves(1)
    t = {tag: {k: torch.from_numpy(_stack(k, v).astype(np.float32)).reshape(
        _SHAPES[k]) for k, v in x[tag].items()} for tag in x}
    mu, nu = dict(t["m"]), dict(t["v"])
    ids = {k: (id(mu[k]), id(nu[k])) for k in mu}
    PO.adamw_update(t["p"], t["g"], mu, nu, torch.tensor(2, dtype=torch.int32),
                    PO.OptimizerConfig())
    assert all((id(mu[k]), id(nu[k])) == ids[k] for k in mu)
