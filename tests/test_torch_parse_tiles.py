"""The port's parse and scan held against the JAX package on inputs built
against the tile design of the Hopper kernels (``tests/torch_inputs.py``).

On the CPU the port's wrappers run their plain versions; the same inputs
go through the kernels on the card in ``tests/test_torch_cuda.py``.  The
JAX per-byte parse runs as the Pallas kernel in interpret mode, the JAX
scan as its Pallas kernel too.  Everything is bitwise: ints by value,
float weights by bit pattern.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_inputs as ti
from repro.core import parse as jparse
from repro.kernels.exclusive_scan.kernel import exclusive_scan_kernel
from repro.kernels.parse_edges.kernel import parse_bytes_kernel
from repro_torch import kernels
from repro_torch.core import parse


def _jax_bytes(rows, owned, weighted, base):
    v, s, d, w = parse_bytes_kernel(
        jnp.asarray(rows), jnp.asarray(owned, jnp.int32), weighted=weighted,
        base=base, interpret=True)
    return (np.asarray(v), np.asarray(s), np.asarray(d),
            None if w is None else np.asarray(w))


def _assert_bytes_equal(got, want, weighted):
    gv, gs, gd, gw = (None if x is None else x.numpy() for x in got)
    wv, ws, wd, ww = want
    assert np.array_equal(gv, wv)
    assert np.array_equal(gs[gv], ws[wv])
    assert np.array_equal(gd[gv], wd[wv])
    if weighted:
        assert np.array_equal(gw[gv].view(np.int32), ww[wv].view(np.int32))
    else:
        assert gw is None


def _line_lengths(row):
    """Lengths of the row's lines, each newline included."""
    return np.diff(np.concatenate([[-1], np.flatnonzero(row == 10)]))


# ---- the inputs do what their names say -------------------------------------

def test_rows_put_a_line_or_an_edge_case_on_every_tile_mark():
    rows = ti.tile_rows(0, True)
    marks = ti.tile_boundaries()
    assert {256, 512, 1024, 4096, 8192, ti.PARSE_TILE,
            ti.OVERLAP + ti.PARSE_TILE}.issubset(marks)
    for r in (0, 5):
        # a line runs across the mark: neither side of it is a newline
        row = rows[r]
        assert all(row[m - 1] != 10 and row[m] != 10 for m in marks)
    row = rows[1]
    kinds = [(row[m - 1] == 13 and row[m] == 10, row[m] == 13,
              row[m] == 10, row[m - 1] == 10) for m in marks]
    assert all(any(k) for k in kinds)
    assert all(any(k[i] for k in kinds) for i in range(4))


def test_hazard_rows_have_their_shapes():
    rows = ti.tile_rows(1, False)
    longs = sorted(_line_lengths(rows[2]))[-3:]
    assert longs[-1] > 2 * ti.PARSE_TILE and longs[0] > ti.PARSE_HALO
    assert not (rows[3] == 10).any()
    lo, hi = ti.OWNED
    assert rows[4][lo] == 10 and rows[4][hi - 1] == 10
    assert rows.shape == (6, ti.ROW_LEN)


# ---- parse_bytes: the plain version against the Pallas kernel --------------

@pytest.mark.parametrize("owned", [ti.OWNED, (0, ti.ROW_LEN),
                                   (100, ti.ROW_LEN - 37)])
@pytest.mark.parametrize("weighted", [False, True])
def test_tile_rows_match_pallas_kernel(weighted, owned):
    rows = ti.tile_rows(2, weighted)
    got = kernels.parse_bytes(torch.from_numpy(rows), *owned,
                              weighted=weighted, base=1)
    _assert_bytes_equal(got, _jax_bytes(rows, owned, weighted, 1), weighted)
    # every hazard row has lines that end in its owned range, the
    # no-newline row none
    per_row = got[0].sum(1).tolist()
    assert per_row[3] == 0 and min(per_row[:3] + per_row[4:]) > 0


@pytest.mark.parametrize("weighted", [False, True])
def test_aliased_span_matches_pallas_kernel(weighted):
    """Rows read through the loader's row stride, overlapping by 64 bytes."""
    rows = ti.tile_rows(3, weighted)
    span = torch.from_numpy(ti.flat_span(rows))
    bufs = span.as_strided(rows.shape, (ti.BETA, 1))
    got = kernels.parse_bytes(bufs, *ti.OWNED, weighted=weighted, base=0)
    want = _jax_bytes(bufs.contiguous().numpy(), ti.OWNED, weighted, 0)
    _assert_bytes_equal(got, want, weighted)
    # the owned-edge row keeps its newline on the last owned byte
    assert bool(got[0][4, ti.OWNED[1] - 1]) and bool(got[0][4, ti.OWNED[0]])


# ---- parse_accumulate over several batches, garbage accumulators ------------

@pytest.mark.parametrize("weighted", [False, True])
def test_parse_accumulate_writes_exactly_its_window(weighted):
    """Three batches of two aliased rows into accumulators that hold
    garbage everywhere, from a non-zero total: each batch writes its
    edges and padding over ``[total, total + edge_bound)`` and nothing
    else, as the reference does."""
    rows = ti.tile_rows(4, weighted)
    span = ti.flat_span(rows)
    edge_cap = ti.ROW_LEN // 4 + 2
    bound = 2 * edge_cap
    start = 11
    cap = start + 3 * bound + 50
    g_src, g_dst, g_w = ti.garbage_accumulators(cap, 4, weighted)
    ref = (jnp.asarray(g_src), jnp.asarray(g_dst),
           None if g_w is None else jnp.asarray(g_w),
           jnp.asarray(start, jnp.int32))
    got = (torch.from_numpy(g_src.copy()), torch.from_numpy(g_dst.copy()),
           None if g_w is None else torch.from_numpy(g_w.copy()),
           torch.tensor(start, dtype=torch.int32))
    for lo in (0, 2, 4):
        last = int(got[3])
        flat = span[lo * ti.BETA:(lo + 1) * ti.BETA + ti.ROW_LEN]
        bufs = torch.from_numpy(flat.copy()).as_strided((2, ti.ROW_LEN),
                                                        (ti.BETA, 1))
        ref = jparse.parse_accumulate(
            *ref, jnp.asarray(bufs.contiguous().numpy()),
            jnp.full(2, ti.OWNED[0], jnp.int32),
            jnp.full(2, ti.OWNED[1], jnp.int32), weighted=weighted, base=1,
            edge_bound=bound, donate=False)
        got = parse.parse_accumulate(*got, bufs, *ti.OWNED,
                                     weighted=weighted, base=1,
                                     edge_bound=bound)
    assert int(got[3]) == int(ref[3]) > start
    for g, r in zip(got[:3], ref[:3]):
        if r is None:
            assert g is None
        else:
            assert np.array_equal(g.numpy().view(np.int32),
                                  np.asarray(r).view(np.int32))
    # garbage past the last window is untouched
    assert np.array_equal(got[0].numpy()[last + bound:],
                          g_src[last + bound:])


@pytest.mark.parametrize("bound", [0, 37])
def test_parse_accumulate_drops_past_edge_bound(bound):
    rows = ti.tile_rows(5, True)[:2]
    g_src, g_dst, g_w = ti.garbage_accumulators(200, 5, True)
    ref = jparse.parse_accumulate(
        jnp.asarray(g_src), jnp.asarray(g_dst), jnp.asarray(g_w),
        jnp.asarray(3, jnp.int32), jnp.asarray(rows),
        jnp.full(2, ti.OWNED[0], jnp.int32),
        jnp.full(2, ti.OWNED[1], jnp.int32), weighted=True, base=1,
        edge_bound=bound, donate=False)
    got = parse.parse_accumulate(
        torch.from_numpy(g_src.copy()), torch.from_numpy(g_dst.copy()),
        torch.from_numpy(g_w.copy()), torch.tensor(3, dtype=torch.int32),
        torch.from_numpy(rows), *ti.OWNED, weighted=True, base=1,
        edge_bound=bound)
    assert int(got[3]) == int(ref[3]) > 3 + bound
    for g, r in zip(got[:3], ref[:3]):
        assert np.array_equal(g.numpy().view(np.int32),
                              np.asarray(r).view(np.int32))


# ---- the scan around its tile, and wrapping ---------------------------------

@pytest.mark.parametrize("n", ti.SCAN_SIZES)
@pytest.mark.parametrize("wrap", [False, True])
def test_scan_tile_sizes_match_pallas_kernel(n, wrap):
    x = ti.scan_input(n, n, wrap)
    excl, total = kernels.exclusive_scan(torch.from_numpy(x))
    w_excl, w_total = exclusive_scan_kernel(jnp.asarray(x), blk=1024,
                                            interpret=True)
    assert np.array_equal(excl.numpy(), np.asarray(w_excl))
    assert int(total) == int(w_total)
    offs = kernels.csr_offsets(torch.from_numpy(x))
    assert offs.shape == (n + 1,) and int(offs[-1]) == int(w_total)
    assert np.array_equal(offs[:-1].numpy(), np.asarray(w_excl))
    if wrap:
        assert int(np.sum(x, dtype=np.int64)) >= 2**32 or n < 8
