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
    four = [torch.zeros(4, dtype=torch.int32) for _ in range(4)]
    with pytest.raises(ValueError):
        kernels.sort_pairs(*four, bits=0)
    with pytest.raises(ValueError):
        kernels.sort_pairs(*four[:3], torch.zeros(3, dtype=torch.int32),
                           bits=4)
    with pytest.raises(ValueError):
        kernels.staged_merge(*four[:3], dst=four[3])


def test_cpu_wrappers_do_not_count_launches():
    kernels.reset_launches()
    kernels.exclusive_scan(torch.ones(4, dtype=torch.int32))
    kernels.degree_histogram(torch.ones(4, dtype=torch.int32),
                             num_vertices=3)
    kernels.parse_bytes(torch.full((1, 8), 10, dtype=torch.uint8), 0, 8,
                        weighted=False, base=1)
    four = [torch.zeros(4, dtype=torch.int32) for _ in range(4)]
    kernels.staged_merge(*kernels.sort_pairs(*four, bits=3), four[2])
    assert set(kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("n,bits", [(0, 1), (1, 1), (500, 5), (3000, 24),
                                    (3000, 31)])
def test_sort_pairs_is_stable_over_the_low_bits(n, bits):
    """Keys with bits above ``bits`` set and many ties: the pairs come out
    ordered by the low bits, ties in input order (numpy's stable sort)."""
    rng = np.random.default_rng(n + bits)
    keys = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    keys[rng.random(n) < 0.5] = 3
    vals = np.arange(n, dtype=np.int32)
    order = np.argsort(keys & ((1 << bits) - 1), kind="stable")
    got = kernels.sort_pairs(
        torch.from_numpy(keys.copy()), torch.from_numpy(vals.copy()),
        torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32),
        bits=bits)
    assert np.array_equal(got[0].numpy(), keys[order])
    assert np.array_equal(got[1].numpy(), vals[order])


@pytest.mark.parametrize("rho,v", [(1, 1), (3, 17), (4, 300)])
@pytest.mark.parametrize("weighted", [False, True])
def test_staged_merge_places_each_run(rho, v, weighted):
    """Sorted ``(p*V + u)`` keys with padding keys, the table computed from
    its definition in numpy, and the merge's targets against a stable sort
    of the valid edges by source (the oracle's order)."""
    rng = np.random.default_rng(rho * v)
    e = 2000
    part = np.sort(rng.integers(0, rho, e))
    u = rng.integers(0, v, e)
    keys = np.where(rng.random(e) < 0.1, rho * v, part * v + u)
    order = np.argsort(keys, kind="stable")
    dst = rng.integers(0, 1000, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    pdeg = np.bincount(keys[keys < rho * v], minlength=rho * v)
    offsets = np.concatenate([[0], np.cumsum(pdeg.reshape(rho, v).sum(0))])
    before = np.cumsum(pdeg.reshape(rho, v), 0) - pdeg.reshape(rho, v)
    start = np.cumsum(pdeg) - pdeg
    delta = (offsets[:-1] + before).reshape(-1) - start
    skeys = torch.from_numpy(keys[order].astype(np.int32))
    svals = torch.from_numpy((order if weighted else dst[order]).astype(
        np.int32))
    got = kernels.staged_merge(
        skeys, svals, torch.from_numpy(delta.astype(np.int32)),
        dst=torch.from_numpy(dst) if weighted else None,
        weights=torch.from_numpy(w) if weighted else None)
    valid = keys < rho * v
    by_src = np.argsort(np.where(valid, u, v), kind="stable")[:valid.sum()]
    n = int(valid.sum())
    assert np.array_equal(got[0].numpy()[:n], dst[by_src])
    assert (got[0].numpy()[n:] == -1).all()
    if weighted:
        assert np.array_equal(got[1].numpy()[:n], w[by_src])
        assert (got[1].numpy()[n:] == 0).all()
    else:
        assert got[1] is None
