"""The port's point reads and row slices held against
``repro.core.source`` on the same text files, on the CPU.

``GraphSource.neighbors``/``degree``/``csr(rows=)`` on a text source slice
the memoized CSR in both packages; the port returns tensors on the
source's device (``degree`` a Python int, as the reference does).
"""
import numpy as np
import pytest
import torch

from repro.core.source import open_graph as jax_open
from repro.core.source import slice_csr as jax_slice
from repro.core.types import CSR as JCSR
from repro_torch import open_graph
from repro_torch.core import CSR, slice_csr


def _graph(tmp_path, *, weighted, base, seed=0, v=60, e=400):
    """Random multigraph text file; the last 3 vertices have no edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v - 3, e)
    dst = rng.integers(0, v - 3, e)
    lines = []
    for i in range(e):
        line = f"{src[i] + base} {dst[i] + base}"
        if weighted:
            line += f" {rng.random() * 9:.3f}"
        lines.append(line)
    path = tmp_path / f"g_{weighted}_{base}.el"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _pair(path, weighted, base):
    return (jax_open(path, weighted=weighted, base=base),
            open_graph(path, weighted=weighted, base=base, device="cpu"))


@pytest.mark.parametrize("weighted,base", [(False, 1), (True, 0)])
def test_point_reads_match_reference(tmp_path, weighted, base):
    path = _graph(tmp_path, weighted=weighted, base=base)
    ref, src = _pair(path, weighted, base)
    v = src.csr().num_rows
    assert v == ref.csr().num_rows
    for u in (0, 1, 13, v // 2, v - 1):
        got = src.neighbors(u)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(ref.neighbors(u)))
        assert src.degree(u) == ref.degree(u)
        assert isinstance(src.degree(u), int)
        if weighted:
            ids, w = src.neighbors(u, with_weights=True)
            rids, rw = ref.neighbors(u, with_weights=True)
            assert np.array_equal(ids.numpy(), np.asarray(rids))
            assert np.array_equal(w.numpy().view(np.int32),
                                  np.asarray(rw).view(np.int32))


@pytest.mark.parametrize("rows", [(9, 31), (0, 5), range(20, 40), (7, 7)])
def test_row_slices_match_reference(tmp_path, rows):
    path = _graph(tmp_path, weighted=True, base=1)
    ref, src = _pair(path, True, 1)
    got, want = src.csr(rows=rows), ref.csr(rows=rows)
    assert got.row_start == want.row_start
    assert got.num_vertices == want.num_vertices
    assert got.num_rows == want.num_rows
    assert np.array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    assert np.array_equal(got.targets.numpy(), np.asarray(want.targets))
    assert np.array_equal(got.weights.numpy().view(np.int32),
                          np.asarray(want.weights).view(np.int32))


def test_full_range_is_the_csr(tmp_path):
    path = _graph(tmp_path, weighted=False, base=1)
    src = open_graph(path, device="cpu")
    full = src.csr()
    part = src.csr(rows=(0, full.num_rows))
    assert torch.equal(part.offsets, full.offsets)
    assert torch.equal(part.targets, full.targets)
    assert part.weights is None


def test_bad_rows_and_ids_raise_as_in_reference(tmp_path):
    path = _graph(tmp_path, weighted=False, base=1)
    ref, src = _pair(path, False, 1)
    v = src.csr().num_rows
    for s in (ref, src):
        with pytest.raises(ValueError):
            s.csr(rows=range(0, 10, 2))
        with pytest.raises(ValueError):
            s.csr(rows=(7, 3))
        with pytest.raises(ValueError):
            s.csr(rows="0:10")
        with pytest.raises(IndexError):
            s.csr(rows=(0, v + 1))
        with pytest.raises(IndexError):
            s.csr(rows=(-1, 3))
        for u in (-1, v):
            with pytest.raises(IndexError):
                s.neighbors(u)
            with pytest.raises(IndexError):
                s.degree(u)
        with pytest.raises(ValueError, match="unweighted"):
            s.neighbors(3, with_weights=True)


def test_slice_csr_matches_reference_and_rejects_local():
    rng = np.random.default_rng(4)
    deg = rng.integers(0, 5, 20)
    off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    tgt = rng.integers(0, 20, int(off[-1])).astype(np.int32)
    csr = CSR(torch.from_numpy(off), torch.from_numpy(tgt), None, 20)
    got = slice_csr(csr, 3, 11)
    want = jax_slice(JCSR(off, tgt, None, 20), 3, 11)
    assert np.array_equal(got.offsets.numpy(), want.offsets)
    assert np.array_equal(got.targets.numpy(), want.targets)
    with pytest.raises(ValueError, match="row_start"):
        slice_csr(got, 0, 2)
