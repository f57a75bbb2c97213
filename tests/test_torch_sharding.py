"""The port's sharding rules held against the JAX package's
(``repro/distributed/sharding.py``), the torch counterpart of
``test_param_shardings_cover_zoo`` (tests/test_distributed_loader.py).

The rules are pure functions of a leaf's path and shape and the mesh's
axis sizes, so no world and no devices are needed: the reference runs on a
``jax.sharding.AbstractMesh`` of the same shape (its rules read only
``mesh.shape``).  For every arch's reduced config, every leaf of the
reference's ``abstract_params(cfg, tp=2)`` (and of ``abstract_caches``)
must get the reference's spec exactly, on a ``(4, 2)`` ``("data",
"model")`` mesh and a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh,
with ``fsdp`` on and off.  Then the placements the spec gives the port's
per-layer tensors, and the state shapes against the reference's
``abstract_state`` and ``abstract_zero1_local_state``.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import abstract_params
from repro.models import transformer as jtfm
from repro.train.state import abstract_state as jabstract_state
from repro.train.step import abstract_zero1_local_state as jabstract_zero1
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import reference_paths
from repro_torch.train.state import abstract_state
from repro_torch.train.step import abstract_zero1_local_state

ARCHS = sorted(jconfigs.ARCHS)
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _leaves(tree):
    return [(tuple(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _mesh(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), dict(zip(names, shape))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, mesh_name):
    jmesh, axes = _mesh(mesh_name)
    jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
    checked = 0
    for path, leaf in _leaves(abstract_params(jcfg, tp=2)):
        for fsdp in (False, True):
            want = jshd.param_pspec(path, leaf.shape, jcfg, jmesh, fsdp=fsdp)
            got = shd.param_pspec(path, leaf.shape, cfg, axes, fsdp=fsdp)
            assert got == tuple(want), (path, fsdp)
            zwant = jshd.zero1_pspec(want, leaf.shape, jmesh)
            assert shd.zero1_pspec(got, leaf.shape, axes) == tuple(zwant), \
                (path, fsdp)
            checked += 1
        for b in (1, 2, 4, 6, 8, 16):
            want = jshd.batch_pspec(jmesh, b, leaf.ndim)
            assert shd.batch_pspec(axes, b, leaf.ndim) == tuple(want)
    for path, leaf in _leaves(jtfm.abstract_caches(jcfg, 8, 16, 2)):
        want = jshd.cache_pspec(path, leaf.shape, jcfg, jmesh)
        assert shd.cache_pspec(path, leaf.shape, cfg, axes) == tuple(want), \
            path
    assert checked > 0


def test_batch_axes_and_dp_axes_match_the_reference():
    for name in MESHES:
        jmesh, axes = _mesh(name)
        assert shd.dp_axes(axes) == jshd.dp_axes(jmesh)
        for b in range(1, 17):
            assert shd.batch_axes(axes, b) == jshd.batch_axes(jmesh, b), b


class _Mesh:
    """What the placement mappers read of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.mesh = torch.empty(shape)
        self.mesh_dim_names = names


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mixtral-8x22b",
                                  "falcon-mamba-7b", "recurrentgemma-2b"])
def test_placements_follow_the_stacked_spec(arch, fsdp):
    """Each per-layer tensor's placements are its stacked leaf's spec with
    the layer entry dropped; the layer axis never shards a per-layer
    tensor (a moment whose rule puts a data axis there replicates)."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = configs.reduced_config(arch)
    model = abstract_state(cfg).params
    mesh = _Mesh((2, 2, 2), ("pod", "data", "model"))
    axes = {"pod": 2, "data": 2, "model": 2}
    pp = shd.param_placements(model, cfg, mesh, fsdp=fsdp)
    mp = shd.moment_placements(model, cfg, mesh, fsdp=fsdp)
    paths = reference_paths(model)
    counts = {}
    for _n, (path, j) in paths.items():
        counts[path] = max(counts.get(path, 0), (j or 0) + 1)
    for name, p in model.named_parameters():
        path, j = paths[name]
        shape = ((counts[path],) if j is not None else ()) + tuple(p.shape)
        spec = shd.param_pspec(tuple(path.split(".")), shape, cfg, axes,
                               fsdp=fsdp)
        for placements, sp in ((pp[name], spec),
                               (mp[name], shd.zero1_pspec(spec, shape,
                                                          axes))):
            lead = 1 if j is not None else 0
            for a, pl in zip(mesh.mesh_dim_names, placements):
                dims = [d for d, e in enumerate(sp)
                        if a == e or (isinstance(e, tuple) and a in e)]
                if dims and dims[0] >= lead:
                    assert pl == Shard(dims[0] - lead), (name, a)
                    assert p.shape[dims[0] - lead] % axes[a] == 0
                else:
                    assert pl == Replicate(), (name, a)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_placements_shard_dim_0_over_the_data_axes(mesh_name):
    from torch.distributed.tensor import Replicate, Shard
    shape, names = MESHES[mesh_name]
    mesh = _Mesh(shape, names)
    batch = {"tokens": torch.empty(8, 16), "odd": torch.empty(6, 3, 2),
             "one": torch.empty(1, 4)}
    got = shd.batch_placements(mesh, batch)
    axes = dict(zip(names, shape))
    for k, v in batch.items():
        spec = shd.batch_pspec(axes, v.shape[0], v.dim())
        lead = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        want = tuple(Shard(0) if a in lead else Replicate() for a in names)
        assert got[k] == want, k
    assert got["tokens"][names.index("data")] == Shard(0)
    assert all(p == Replicate() for p in got["one"])


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_shapes_match_the_reference(arch):
    jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
    ap = abstract_params(jcfg)
    for compression in (False, True):
        want = jabstract_state(ap, compression=compression)
        got = abstract_state(cfg, compression=compression)
        assert got.step.is_meta and got.step.dtype == torch.int32
        assert all(p.is_meta and p.dtype == torch.float32
                   for p in got.params.parameters())
        paths = reference_paths(got.params)
        trees = [(want.params, dict(got.params.named_parameters())),
                 (want.mu, got.mu), (want.nu, got.nu)]
        if compression:
            trees.append((want.error, got.error))
        else:
            assert got.error is None and want.error is None
        for jtree, tree in trees:
            shapes = {".".join(k): l.shape for k, l in _leaves(jtree)}
            stacked = {}
            for name, t in tree.items():
                path, j = paths[name]
                if j is None:
                    assert tuple(t.shape) == shapes[path], name
                else:
                    stacked.setdefault(path, []).append(tuple(t.shape))
            for path, layers in stacked.items():
                assert (len(layers),) + layers[0] == shapes[path], path
                assert len(set(layers)) == 1, path


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_zero1_state_shapes_match_the_reference(arch, tp):
    jcfg, cfg = jconfigs.reduced_config(arch), configs.reduced_config(arch)
    want = jabstract_zero1(abstract_params(jcfg, tp), 4, tp)
    got = abstract_zero1_local_state(cfg, 4, tp)
    for jtree, tree in ((want.mu, got.mu), (want.nu, got.nu)):
        shapes = {".".join(k): tuple(l.shape) for k, l in _leaves(jtree)}
        assert {k: tuple(v.shape) for k, v in tree.items()} == shapes
        assert all(v.dtype == torch.float32 for v in tree.values())
    assert got.error is None and want.error is None
    assert tuple(got.step.shape) == tuple(want.step.shape) == ()
