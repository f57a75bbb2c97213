"""The port's launch cells held against the JAX package: ``launch.
accounting`` (plain arithmetic over a config) and ``launch.shapes`` give
the reference's numbers exactly.  ``build_cell``'s defaults are held in
``tests/test_torch_fsdp.py``, whose gloo worlds give it a mesh."""
import itertools
import types

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import accounting as jacc
from repro.launch import shapes as jshapes
from repro_torch import configs
from repro_torch.launch import accounting as acc
from repro_torch.launch import shapes

ARCHS = tuple(configs.ARCHS)
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
REMATS = ("full", "dots", "dots_no_batch", "nothing", "everything", None)


def test_the_port_has_the_reference_s_archs_and_shapes():
    assert set(ARCHS) == set(jconfigs.ARCHS)
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, sc in jshapes.SHAPES.items():
        mine = shapes.SHAPES[name]
        assert (mine.name, mine.seq, mine.global_batch, mine.kind) == \
            (sc.name, sc.seq, sc.global_batch, sc.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_accounting_is_the_reference_s(arch):
    """Every term, exactly, for 4 shapes x tp in {1, 2, 16} x 256 and 512
    ranks x fsdp x every remat policy."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for shape, tp, size, fsdp, remat in itertools.product(
            shapes.SHAPES, (1, 2, 16), (256, 512), (False, True), REMATS):
        sc = shapes.SHAPES[shape]
        kw = dict(seq=sc.seq, batch=sc.global_batch, kind=sc.kind)
        what = (shape, tp, size, fsdp, remat)
        assert acc.step_flops(cfg, tp, remat=remat, **kw) == \
            jacc.step_flops(jcfg, tp, remat=remat, **kw), what
        for accum in (1, 4):
            assert acc.step_bytes_per_device(
                cfg, tp, size, accum=accum, fsdp=fsdp, **kw) == \
                jacc.step_bytes_per_device(jcfg, tp, size, accum=accum,
                                           fsdp=fsdp, **kw), what
        assert acc.model_flops(cfg, **kw) == jacc.model_flops(jcfg, **kw)
        mine = acc.cell_cost(cfg, tp, size, accum=2, remat=remat,
                             fsdp=fsdp, **kw)
        want = jacc.cell_cost(jcfg, tp, size, accum=2, remat=remat,
                              fsdp=fsdp, **kw)
        assert (mine.flops_total, mine.bytes_per_device,
                mine.model_flops) == (want.flops_total,
                                      want.bytes_per_device,
                                      want.model_flops), what


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_input_specs_are_the_reference_s(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for shape in shapes.SHAPES:
        assert shapes.cell_enabled(cfg, shape) == \
            jshapes.cell_enabled(jcfg, shape), shape
        mine = shapes.input_specs(cfg, shape)
        want = jshapes.input_specs(jcfg, shape)
        assert list(mine) == list(want), shape
        for k, v in want.items():
            assert mine[k].device.type == "meta"
            assert tuple(mine[k].shape) == tuple(v.shape), (shape, k)
            assert str(mine[k].dtype) == f"torch.{np.dtype(v.dtype)}", \
                (shape, k)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_default_accum_is_the_reference_s(arch, mesh):
    """Over the production meshes' axis sizes, given as a dict to the port
    and as a mesh-like ``shape`` to the reference."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    axes = MESHES[mesh]
    for shape in shapes.SHAPES:
        assert shapes.default_accum(cfg, shape, axes) == \
            jshapes.default_accum(jcfg, shape,
                                  types.SimpleNamespace(shape=axes)), shape
