"""The port's ``neighbor_gather`` held against the JAX package, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; it is compared here
bitwise with ``repro.kernels.neighbor_gather.ref.neighbor_gather_ref``
(the Pallas kernel itself no longer runs on this jax).  Inputs are made
with numpy from a seed.  The CUDA kernel is held against the plain version
by ``tests/test_torch_cuda.py`` on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.neighbor_gather.ref import neighbor_gather_ref as jax_ref
from repro_torch import kernels

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _csr(rng, v, e, hot=None):
    """Random CSR offsets (int32) and targets; ``hot`` gets most edges."""
    if v == 0:
        return np.zeros(1, np.int32), np.zeros(0, np.int32)
    src = rng.integers(0, v, e)
    if hot is not None:
        src[: e // 2] = hot
    deg = np.bincount(src, minlength=v)
    off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    return off, rng.integers(0, v, e).astype(np.int32)


def _ids(rng, v, b):
    """In-range ids, every out-of-range neighbour of [0, v] and the int32
    extremes."""
    edge = np.arange(-v - 3, v + 4)
    extremes = [I32_MIN, I32_MIN + 1, -1, I32_MAX - 1, I32_MAX]
    return np.concatenate([rng.integers(0, max(v, 1), b), edge,
                           extremes]).astype(np.int32)


def _check(ids, off, tgt, width):
    want = jax_ref(jnp.asarray(ids), jnp.asarray(off), jnp.asarray(tgt),
                   width=width)
    for offsets in (off, off.astype(np.int64)):
        nbrs, deg = kernels.neighbor_gather(
            torch.from_numpy(ids), torch.from_numpy(offsets),
            torch.from_numpy(tgt), width=width)
        assert nbrs.dtype == deg.dtype == torch.int32
        assert nbrs.shape == (len(ids), width) and deg.shape == (len(ids),)
        assert np.array_equal(nbrs.numpy(), np.asarray(want[0]))
        assert np.array_equal(deg.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("v,e,width,hot", [
    (4, 10, 8, None),        # the docstring's V = 4 case
    (40, 300, 16, None),     # E > width, mixed degrees
    (30, 500, 8, 3),         # one vertex's degree far above width
    (9, 5, 16, None),        # E < width
    (6, 0, 8, None),         # edgeless
    (0, 0, 4, None),         # no vertices
    (50, 2000, 128, 7),      # the reference's default width
])
def test_neighbor_gather_matches_reference(v, e, width, hot):
    rng = np.random.default_rng(v * 1000 + e + width)
    off, tgt = _csr(rng, v, e, hot)
    _check(_ids(rng, v, 64), off, tgt, width)


def test_negative_ids_index_as_jax_does():
    """V = 4, E = 10: id -1 reads offsets[V] - offsets[0] = -10 and an
    all -1 row; id -5 wraps to -5 + 5 = 0, vertex 0's row."""
    off = np.array([0, 3, 3, 7, 10], np.int32)
    tgt = np.arange(10, dtype=np.int32) + 100
    nbrs, deg = kernels.neighbor_gather(
        torch.tensor([-1, -5, 0, 1], dtype=torch.int32),
        torch.from_numpy(off.astype(np.int64)), torch.from_numpy(tgt),
        width=4)
    assert deg.tolist() == [-10, 3, 3, 0]
    assert nbrs.tolist() == [[-1] * 4, [100, 101, 102, -1],
                             [100, 101, 102, -1], [-1] * 4]
    _check(np.array([-1, -5, 0, 1], np.int32), off, tgt, 4)


def test_empty_batch():
    nbrs, deg = kernels.neighbor_gather(
        torch.zeros(0, dtype=torch.int32), torch.tensor([0, 1]),
        torch.tensor([0], dtype=torch.int32), width=8)
    assert nbrs.shape == (0, 8) and deg.shape == (0,)


@pytest.mark.parametrize("kw,match", [
    (dict(vertices=torch.zeros(3, dtype=torch.int64)), "int32"),
    (dict(targets=torch.zeros(3, dtype=torch.int64)), "int32"),
    (dict(offsets=torch.zeros(3, dtype=torch.float32)), "int64 or int32"),
    (dict(offsets=torch.zeros(0, dtype=torch.int64)), "at least one"),
    (dict(vertices=torch.zeros((2, 2), dtype=torch.int32)), "1-D"),
    (dict(width=0), "positive"),
])
def test_neighbor_gather_rejects_bad_inputs(kw, match):
    args = dict(vertices=torch.zeros(3, dtype=torch.int32),
                offsets=torch.tensor([0, 1, 3]),
                targets=torch.zeros(3, dtype=torch.int32), width=8)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        kernels.neighbor_gather(args.pop("vertices"), args.pop("offsets"),
                                args.pop("targets"), **args)


def test_cpu_path_launches_nothing():
    kernels.reset_launches()
    kernels.neighbor_gather(torch.tensor([0, 1], dtype=torch.int32),
                            torch.tensor([0, 1, 2]),
                            torch.tensor([1, 0], dtype=torch.int32))
    assert kernels.LAUNCHES["neighbor_gather"] == 0
