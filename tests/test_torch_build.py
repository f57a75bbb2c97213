"""The port's CSR builders and degree functions held against the JAX
package (``repro.core.build``) and the numpy oracle ``csr_np``, on the CPU.
Bitwise: offsets, targets, and weights by bit pattern."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_inputs as ti
from repro.core import build as jbuild
from repro.core import degrees as jdegrees
from repro_torch.core import EdgeList, build, convert_to_csr, degrees


def _edges(case, rng):
    """(src with -1 padding, dst, weights, V) for one shape."""
    if case == "random":
        v, e = 50, 400
        src = rng.integers(0, v, e)
    elif case == "skew":
        v, e = 40, 300
        src = np.minimum(rng.zipf(1.6, e) - 1, v - 1)
    elif case == "empty":
        v, e = 6, 0
        src = np.zeros(0, np.int64)
    elif case == "padding_only":
        v, e = 9, 16
        src = np.full(e, -1)
    elif case == "v1":
        v, e = 1, 25
        src = np.zeros(e, np.int64)
    elif case == "tiny":                          # fewer edges than rho
        v, e = 5, 3
        src = rng.integers(0, v, e)
    elif case == "hub":                           # half the edges on one id
        v, e = 40, 400
        src = np.where(rng.random(e) < 0.5, 11, rng.integers(0, v, e))
    else:
        raise ValueError(case)
    src = src.astype(np.int32)
    if case in ("random", "skew", "hub"):
        src[rng.random(e) < 0.2] = -1             # padding sprinkled in
        src = np.concatenate([src, np.full(7, -1, np.int32)])
        e = len(src)
    dst = rng.integers(0, max(v, 1), e).astype(np.int32)
    dst[src < 0] = -1
    w = rng.normal(size=e).astype(np.float32)
    return src, dst, w, v


CASES = ["random", "skew", "empty", "padding_only", "v1", "tiny", "hub"]


def _check(got, want_offsets, want_targets, want_w, weighted, n_valid=None):
    offsets, targets, w = got
    assert offsets.dtype == torch.int32
    assert np.array_equal(offsets.numpy(), np.asarray(want_offsets))
    k = len(want_targets) if n_valid is None else n_valid
    assert np.array_equal(targets.numpy()[:k], np.asarray(want_targets)[:k])
    if weighted:
        assert np.array_equal(w.numpy()[:k].view(np.int32),
                              np.asarray(want_w)[:k].view(np.int32))
    else:
        assert w is None


def _call(fn_t, fn_j, src, dst, w, v, weighted, **kw):
    got = fn_t(torch.from_numpy(src), torch.from_numpy(dst),
               torch.from_numpy(w) if weighted else None, v,
               weighted=weighted, **kw)
    want = fn_j(jnp.asarray(src), jnp.asarray(dst),
                jnp.asarray(w) if weighted else None, v, weighted=weighted,
                **kw)
    return got, want


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("method", ["global", "staged", "binned"])
def test_builders_match_jax_and_oracle(case, weighted, method):
    rng = np.random.default_rng(CASES.index(case))
    src, dst, w, v = _edges(case, rng)
    fn_t = getattr(build, f"csr_{method}")
    fn_j = getattr(jbuild, f"csr_{method}")
    got, want = _call(fn_t, fn_j, src, dst, w, v, weighted)
    _check(got, *want, weighted)
    oracle = jbuild.csr_np(src, dst, w if weighted else None, v)
    n = int((src >= 0).sum())
    _check(got, oracle.offsets, oracle.targets, oracle.weights, weighted,
           n_valid=n)


@pytest.mark.parametrize("bin_bits", [None, 1, 3, 64])
def test_binned_bin_widths_match_jax(bin_bits):
    """bin_bits of 1 forces many levels; 64 is wider than V."""
    src, dst, w, v = _edges("random", np.random.default_rng(9))
    got, want = _call(build.csr_binned, jbuild.csr_binned, src, dst, w, v,
                      True, bin_bits=bin_bits)
    _check(got, *want, True)


@pytest.mark.parametrize("rho", [1, 3, 4, 7, 8])
def test_staged_rho_matches_jax(rho):
    src, dst, w, v = _edges("skew", np.random.default_rng(rho))
    got, want = _call(build.csr_staged, jbuild.csr_staged, src, dst, w, v,
                      True, rho=rho)
    _check(got, *want, True)


def test_ids_at_or_above_v_follow_the_reference():
    """csr_global/staged drop src >= V; csr_binned clips it to V-1."""
    src = np.array([0, 5, 2, 9, 2, -1], np.int32)
    dst = np.arange(6, dtype=np.int32)
    w = np.linspace(0, 1, 6).astype(np.float32)
    for method in ("global", "staged", "binned"):
        got, want = _call(getattr(build, f"csr_{method}"),
                          getattr(jbuild, f"csr_{method}"), src, dst, w, 4,
                          True)
        _check(got, *want, True)


@pytest.mark.parametrize("case", ti.STAGED_CASES)
@pytest.mark.parametrize("rho", [1, 4, 7])
@pytest.mark.parametrize("weighted", [False, True])
def test_staged_edge_shapes_match_jax_and_oracle(case, rho, weighted):
    """Partitions cut unequally or left empty, padding, ids >= V, V = 1 and
    a hub: bitwise the reference (padding's slots included) and, over the
    edges with ids in [0, V), the oracle."""
    src, dst, w, v = ti.staged_edges(case, rho)
    got, want = _call(build.csr_staged, jbuild.csr_staged, src, dst, w, v,
                      weighted, rho=rho)
    _check(got, *want, weighted)
    keep = (src >= 0) & (src < v)
    oracle = jbuild.csr_np(src[keep], dst[keep], w[keep] if weighted
                           else None, v)
    _check(got, oracle.offsets, oracle.targets, oracle.weights, weighted,
           n_valid=int(keep.sum()))
    assert (got[1].numpy()[int(keep.sum()):] == -1).all()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("spare", [0, 1000, 4001])
def test_staged_sorts_in_donated_buffers(weighted, spare):
    """``donate``: the first ``num_edges`` slots are the edges, the sort may
    use the slots past them (``spare`` >= the edges: enough for both of its
    buffers), and the product is the undonated build's, bitwise."""
    src, dst, w, v = ti.staged_edges("padding", 11)
    want = build.csr_staged(torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(w), v, weighted=weighted)

    def grown(a):
        return torch.from_numpy(np.concatenate(
            [a, np.full(spare, 12345, a.dtype)]))

    got = build.csr_staged(grown(src), grown(dst), grown(w), v,
                           weighted=weighted, num_edges=len(src),
                           donate=True)
    assert got[1].shape == (len(src),)
    _check(got, want[0].numpy(), want[1].numpy(),
           want[2].numpy() if weighted else None, weighted)


@pytest.mark.parametrize("method", ["global", "staged", "binned"])
def test_convert_to_csr_leaves_the_edge_list_untouched(method):
    src, dst, w, v = ti.staged_edges("hub", 5)
    keep = src >= 0
    el = EdgeList(torch.from_numpy(src[keep]), torch.from_numpy(dst[keep]),
                  torch.from_numpy(w[keep]), int(keep.sum()), v)
    before = [t.clone() for t in (el.src, el.dst, el.weights)]
    got = convert_to_csr(el, method=method)
    for t, b in zip((el.src, el.dst, el.weights), before):
        assert torch.equal(t.view(torch.int32), b.view(torch.int32))
    oracle = jbuild.csr_np(src[keep], dst[keep], w[keep], v)
    assert np.array_equal(got.offsets.numpy(), oracle.offsets)
    assert np.array_equal(got.targets.numpy(), oracle.targets)
    assert np.array_equal(got.weights.numpy().view(np.int32),
                          oracle.weights.view(np.int32))


def test_offsets_width_guard(monkeypatch):
    monkeypatch.setattr(build, "INT32_OFFSETS_LIMIT", 10)
    x = torch.zeros(11, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds int32 offsets"):
        build.csr_global(x, x, None, 3)


def test_binned_key_width_guard():
    assert build._bin_level_widths(22, 4, 4) == \
        jbuild._bin_level_widths(22, 4, 4)
    assert build._ceil_log2(2**26) == jbuild._ceil_log2(2**26) == 26


def test_degree_functions_match_reference():
    rng = np.random.default_rng(3)
    src = rng.integers(-1, 40, 500).astype(np.int32)
    t = torch.from_numpy(src)
    want = np.asarray(jdegrees.degrees_global(jnp.asarray(src), 37))
    assert np.array_equal(degrees.degrees_global(t, 37).numpy(), want)
    assert np.array_equal(degrees.degrees_sort(t, 37).numpy(), want)
    part = degrees.degrees_partitioned(t, 37, rho=4)
    jpart = jdegrees.degrees_partitioned(jnp.asarray(src), 37, rho=4)
    assert np.array_equal(part.numpy(), np.asarray(jpart))
    assert np.array_equal(degrees.combine_degrees(part).numpy(), want)
    assert np.array_equal(degrees.degrees_np(src, 37),
                          jdegrees.degrees_np(src, 37))
    offs = degrees.offsets_from_degrees(torch.tensor(want))
    assert np.array_equal(
        offs.numpy(),
        np.asarray(jdegrees.offsets_from_degrees(jnp.asarray(want), 37)))


def test_csr_np_copy_matches_reference():
    src, dst, w, v = _edges("skew", np.random.default_rng(4))
    a = build.csr_np(src, dst, w, v)
    b = jbuild.csr_np(src, dst, w, v)
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.targets, b.targets)
    assert np.array_equal(a.weights, b.weights)
