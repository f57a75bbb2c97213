"""The reference against a brute-force CSR, and the comparison."""
import numpy as np
import pytest

from gvelbench import reference


def brute_csr(src, dst, w, v):
    rows = [[] for _ in range(v)]
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        rows[s].append((d, None if w is None else w[i]))
    offsets = np.cumsum([0] + [len(r) for r in rows])
    targets = np.array([d for r in rows for d, _ in r], np.int32)
    weights = None if w is None else \
        np.array([x for r in rows for _, x in r], np.float32)
    return offsets, targets, weights


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_is_the_brute_force_csr(seed, weighted):
    rng = np.random.default_rng(seed)
    v = int(rng.integers(1, 40))
    e = int(rng.integers(0, 300))
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    w = rng.integers(1, 256, e).astype(np.float32) if weighted else None
    ref = reference.csr(src, dst, w, v)
    off, tgt, ww = brute_csr(src, dst, w, v)
    assert np.array_equal(ref["offsets"], off)
    assert np.array_equal(ref["targets"], tgt)
    if weighted:
        assert np.array_equal(ref["weights"], ww)
    order = np.argsort(src, kind="stable")
    assert np.array_equal(reference.stable_order(src), order)


def test_counts_and_controls():
    src = np.array([1, 0, 1, 1, 0], np.int32)
    dst = np.array([7, 8, 9, 6, 5], np.int32)
    ref = reference.csr(src, dst, None, 2)
    assert ref["targets"].tolist() == [8, 5, 7, 9, 6]
    ctl = reference.control_csr(src, dst, None, 2)
    assert ctl["targets"].tolist() == [5, 8, 6, 9, 7]
    c = reference.compare_csr(ctl, ref, False, 2)
    assert c == {"vertices_off": 0, "offsets_wrong": 0, "targets_wrong": 4}
    edges = reference.control_edges(src, dst, None)
    assert edges["src"].tolist() == [0, 0, 1, 1, 1]
    e = reference.compare_edges(edges, src, dst, None, 2)
    assert e["src_wrong"] == 2 and e["dst_wrong"] == 5
    assert reference.differing(np.arange(3), np.arange(5)) == 2
    assert reference.worst([{"a": 1}, {"a": 3, "b": 0}]) == {"a": 3, "b": 0}
