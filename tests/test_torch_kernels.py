"""The port's kernel wrappers held against the JAX kernels.

On the CPU the wrappers run their plain PyTorch versions, compared here
with the Pallas kernels in interpret mode (bitwise: integer results).  The
CUDA kernels themselves are held against the plain versions by
``tests/test_torch_cuda.py`` on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.degree_histogram.kernel import degree_histogram_kernel
from repro.kernels.exclusive_scan.kernel import exclusive_scan_kernel
from repro.kernels.exclusive_scan.ref import exclusive_scan_ref
from repro_torch import kernels


def _src(rng, e, v):
    """Ids in [-1, v + 3): padding, in-range ids and ids >= V."""
    return rng.integers(-1, v + 3, e).astype(np.int32)


@pytest.mark.parametrize("e,v", [(0, 5), (1, 1), (500, 37), (3000, 600),
                                 (64, 0)])
def test_degree_histogram_matches_pallas_kernel(e, v):
    src = _src(np.random.default_rng(e + v), e, v)
    got = kernels.degree_histogram(torch.from_numpy(src), num_vertices=v)
    assert got.dtype == torch.int32 and got.shape == (v,)
    if v:
        want = degree_histogram_kernel(jnp.asarray(src), num_vertices=v,
                                       e_blk=256, vt=128, interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(want))
    want_np = np.bincount(src[(src >= 0) & (src < v)], minlength=v)
    assert np.array_equal(got.numpy(), want_np)


@pytest.mark.parametrize("n", [1, 7, 1024, 3001])
def test_exclusive_scan_matches_pallas_kernel(n):
    x = np.random.default_rng(n).integers(0, 50, n).astype(np.int32)
    excl, total = kernels.exclusive_scan(torch.from_numpy(x))
    w_excl, w_total = exclusive_scan_kernel(jnp.asarray(x), blk=256,
                                            interpret=True)
    assert np.array_equal(excl.numpy(), np.asarray(w_excl))
    assert total.dtype == torch.int32 and total.shape == ()
    assert int(total) == int(w_total)
    offs = kernels.csr_offsets(torch.from_numpy(x))
    assert offs.tolist() == [0, *np.cumsum(x).tolist()]


def test_exclusive_scan_wraps_in_int32():
    x = np.full(5, 2**30, np.int32)
    excl, total = kernels.exclusive_scan(torch.from_numpy(x))
    w_excl, w_total = exclusive_scan_ref(jnp.asarray(x))
    assert np.array_equal(excl.numpy(), np.asarray(w_excl))
    assert int(total) == int(w_total) == 2**30 * 5 - 2**32


def test_exclusive_scan_empty_matches_ref():
    """N = 0: the JAX kernel leaves its carry unwritten, so the oracle is
    ``exclusive_scan_ref``."""
    excl, total = kernels.exclusive_scan(torch.zeros(0, dtype=torch.int32))
    w_excl, w_total = exclusive_scan_ref(jnp.zeros(0, jnp.int32))
    assert excl.shape == (0,) and np.asarray(w_excl).shape == (0,)
    assert int(total) == int(w_total) == 0
    assert kernels.csr_offsets(torch.zeros(0, dtype=torch.int32)).tolist() \
        == [0]


def test_wrappers_refuse_wrong_input():
    with pytest.raises(ValueError):
        kernels.exclusive_scan(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.degree_histogram(torch.zeros((2, 2, 2), dtype=torch.int32),
                                 num_vertices=3)
    with pytest.raises(ValueError):
        kernels.parse_bytes(torch.zeros(8, dtype=torch.uint8), 0, 8,
                            weighted=False, base=1)


def test_cpu_wrappers_do_not_count_launches():
    kernels.reset_launches()
    kernels.exclusive_scan(torch.ones(4, dtype=torch.int32))
    kernels.degree_histogram(torch.ones(4, dtype=torch.int32),
                             num_vertices=3)
    kernels.parse_bytes(torch.full((1, 8), 10, dtype=torch.uint8), 0, 8,
                        weighted=False, base=1)
    assert set(kernels.LAUNCHES.values()) == {0}
