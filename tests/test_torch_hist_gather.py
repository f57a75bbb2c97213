"""The port's ``degree_histogram`` (1-D and the 2-D batch of rows) and
``neighbor_gather`` held against the JAX package on inputs built against
the Hopper kernels' geometry (``tests/torch_inputs.py``), on the CPU.

On the CPU the wrappers run their plain versions.  The JAX histogram runs
as its Pallas kernel in interpret mode, row by row; the JAX gather as its
jnp oracle ``neighbor_gather_ref`` (the Pallas gather no longer runs on
this jax).  The same inputs go through the CUDA kernels in
``tests/test_torch_cuda.py``.  Everything is bitwise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_inputs as ti
from repro.core import build as jbuild
from repro.kernels.degree_histogram.kernel import degree_histogram_kernel
from repro.kernels.neighbor_gather.ref import neighbor_gather_ref
from repro_torch import kernels
from repro_torch.core import build, degrees

V = 61            # not a multiple of the Pallas vertex tile


def _pallas_hist(row: np.ndarray, v: int = V) -> np.ndarray:
    return np.asarray(degree_histogram_kernel(
        jnp.asarray(row), num_vertices=v, e_blk=2048, vt=64, interpret=True))


def _hist_cases():
    cases = {"sorted_runs": ti.sorted_runs(9000, V, 1),
             "one_id": np.full(6000, 17, np.int32),
             "one_invalid_id": np.full(5000, V, np.int32)}
    for e in ti.HIST_SIZES:
        cases[f"sorted_{e}"] = np.sort(ti.stream_ids(e, V, e))
        cases[f"stream_{e}"] = ti.stream_ids(e, V, e + 1)
    return cases


HIST_CASES = _hist_cases()


@pytest.mark.parametrize("name", sorted(HIST_CASES))
def test_histogram_1d_matches_pallas(name):
    src = HIST_CASES[name]
    got = kernels.degree_histogram(torch.from_numpy(src), num_vertices=V)
    assert got.shape == (V,) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _pallas_hist(src))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_histogram_of_a_view_at_a_storage_offset(offset):
    base = torch.from_numpy(ti.sorted_runs(4100, V, offset))
    view = base[offset:]
    assert view.storage_offset() == offset
    got = kernels.degree_histogram(view, num_vertices=V)
    assert np.array_equal(got.numpy(), _pallas_hist(view.numpy()))


@pytest.mark.parametrize("rho,p", [(1, 4097), (3, 1365), (4, 4099),
                                   (8, 517)])
def test_histogram_2d_matches_pallas_row_by_row(rho, p):
    """``(rho, P)`` with ``P % 4 != 0``: rows sorted, ending in the padding
    key V, with -1 and ids >= V among them."""
    src = ti.padded_partitions(rho, p, V, rho)
    got = kernels.degree_histogram(torch.from_numpy(src), num_vertices=V)
    assert got.shape == (rho, V) and got.dtype == torch.int32
    for r in range(rho):
        assert np.array_equal(got[r].numpy(), _pallas_hist(src[r]))


def test_histogram_2d_edges():
    empty = kernels.degree_histogram(torch.zeros((3, 0), dtype=torch.int32),
                                     num_vertices=4)
    assert empty.shape == (3, 4) and not empty.any()
    assert kernels.degree_histogram(torch.ones((2, 5), dtype=torch.int32),
                                    num_vertices=0).shape == (2, 0)


@pytest.mark.parametrize("rho", [1, 3, 4, 8])
def test_partitioned_degrees_in_one_call(rho, monkeypatch):
    """``degrees_partitioned`` pads its chunks to one length and counts
    them in one 2-D call, equal to the reference's."""
    from repro.core import degrees as jdegrees
    src = ti.stream_ids(1001, V, rho)
    calls = []
    real = degrees.degree_histogram
    monkeypatch.setattr(degrees, "degree_histogram",
                        lambda s, **kw: calls.append(s.shape) or real(s, **kw))
    got = degrees.degrees_partitioned(torch.from_numpy(src), V, rho=rho)
    want = jdegrees.degrees_partitioned(jnp.asarray(src), V, rho=rho)
    assert calls == [(rho, -(-1001 // rho))]
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rho", [1, 3, 4, 8])
def test_csr_staged_counts_all_partitions_in_one_call(rho, monkeypatch):
    """``csr_staged`` counts its rho partitions in one histogram call, over
    the sorted ``(partition, source)`` keys of all the edges and ``rho * V``
    bins, and stays bitwise against the reference on sorted-run sources
    with padding."""
    rng = np.random.default_rng(rho)
    src = ti.sorted_runs(3001, V, rho)
    rng.shuffle(src)
    src[rng.random(len(src)) < 0.1] = -1
    dst = rng.integers(0, V, len(src)).astype(np.int32)
    w = rng.normal(size=len(src)).astype(np.float32)
    calls = []
    real = build.degree_histogram
    monkeypatch.setattr(build, "degree_histogram",
                        lambda s, **kw: calls.append((tuple(s.shape), kw))
                        or real(s, **kw))
    offsets, targets, weights = build.csr_staged(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w), V,
        rho=rho, weighted=True)
    assert calls == [((len(src),), {"num_vertices": rho * V})]
    j_off, j_tgt, j_w = jbuild.csr_staged(jnp.asarray(src), jnp.asarray(dst),
                                          jnp.asarray(w), V, rho=rho,
                                          weighted=True)
    assert np.array_equal(offsets.numpy(), np.asarray(j_off))
    assert np.array_equal(targets.numpy(), np.asarray(j_tgt))
    assert np.array_equal(weights.numpy().view(np.int32),
                          np.asarray(j_w).view(np.int32))


@pytest.mark.parametrize("width", ti.GATHER_WIDTHS)
@pytest.mark.parametrize("b", [*ti.GATHER_BATCHES, 2 * ti.GATHER_GROUP + 1])
def test_gather_widths_and_groups_match_reference(width, b):
    """Widths off and on the int4 path, batches around the warp's group of
    32 ids, rows at every ``lo % 4``, a hot vertex of degree far above the
    width, int64 and int32 offsets."""
    off, tgt = ti.gather_csr(70, 40 * width, width, width)
    ids = ti.gather_ids(70, b, b)
    want = neighbor_gather_ref(jnp.asarray(ids), jnp.asarray(off),
                               jnp.asarray(tgt), width=width)
    for offsets in (off, off.astype(np.int32)):
        nbrs, deg = kernels.neighbor_gather(
            torch.from_numpy(ids), torch.from_numpy(offsets),
            torch.from_numpy(tgt), width=width)
        assert nbrs.shape == (b, width)
        assert np.array_equal(nbrs.numpy(), np.asarray(want[0]))
        assert np.array_equal(deg.numpy(), np.asarray(want[1]))
