"""The port's parse and staging held against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both.  Everything is
bitwise: ints by value, float weights by bit pattern.  The JAX per-byte
parse runs as the Pallas kernel in interpret mode.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import blocks as jblocks
from repro.core import parse as jparse
from repro.kernels.parse_edges.kernel import parse_bytes_kernel
from repro_torch.core import blocks, parse

BUF_LEN = 512          # one interpret-mode kernel shape for every case
NB = 2

HAZARDS = (
    b"12345678901 2\n"            # token value wraps in int32
    b"1 2 123456789.123\n"        # weight mantissa wraps
    b"3 4 1.2.5\n"                # fraction after the LAST dot
    b"1 2 7-2\n"                  # a minus anywhere negates
    b"1 2 -\n"                    # lone minus -> -0.0
    b"5 6\n"                      # missing weight -> 1.0
    b"# c 1 2\n"                  # bad byte: dropped
    b"1 2 3 4\n"                  # tokens past the third ignored
    b"7 8\r\n"                    # CRLF
    b"\t9\t10  2.50 \n"           # tabs and blanks
    b"abc\n1 x 2\n\n.\n-\n"       # garbage, blank, one-token lines
    b"0 0 0.0\n"
)


def _rows(texts, n=BUF_LEN):
    out = np.full((len(texts), n), 10, np.uint8)
    for r, t in enumerate(texts):
        b = np.frombuffer(t, np.uint8)[:n]
        out[r, :len(b)] = b
    return out


def _random_text(rng, n_lines, weighted):
    lines = []
    for _ in range(n_lines):
        u, v = rng.integers(0, 10**int(rng.integers(1, 10)), 2)
        kind = rng.integers(0, 10)
        if kind == 0:
            lines.append(b"% comment 1 2")
        elif kind == 1:
            lines.append(f"{u} {v}\r".encode())
        elif kind == 2:
            lines.append(b"")
        elif weighted:
            lines.append(f"{u} {v} {rng.normal() * 100:.{rng.integers(0, 6)}f}"
                         .encode())
        else:
            lines.append(f"{u}\t{v}".encode())
    return b"\n".join(lines) + b"\n"


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


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("base", [0, 1])
def test_parse_bytes_hazards_match_pallas_kernel(weighted, base):
    rows = _rows([HAZARDS, HAZARDS[7:]])
    owned = (0, BUF_LEN)
    got = parse._parse_block_bytes(torch.from_numpy(rows), *owned,
                                   weighted=weighted, base=base)
    _assert_bytes_equal(got, _jax_bytes(rows, owned, weighted, base),
                        weighted)


def test_hazard_values():
    rows = _rows([HAZARDS])
    valid, src, dst, w = parse._parse_block_bytes(
        torch.from_numpy(rows), 0, BUF_LEN, weighted=True, base=1)
    v = valid[0]
    s, d, ww = src[0][v].tolist(), dst[0][v].tolist(), w[0][v]
    assert s[0] == -949288396                   # 12345678901 - 1, wrapped
    assert ww[1].item() == -2133145.5
    assert ww[2].item() == 12.5
    assert ww[3].item() == -72.0
    assert ww[4].item() == 0.0 and torch.signbit(ww[4])
    assert ww[5].item() == 1.0
    assert (s[6], d[6], ww[6].item()) == (0, 1, 3.0)   # "1 2 3 4"
    assert len(s) == 10                          # "# c 1 2" and garbage out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_parse_bytes_random_text_matches_pallas_kernel(seed, weighted):
    rng = np.random.default_rng(seed)
    rows = _rows([_random_text(rng, 40, weighted) for _ in range(NB)])
    owned = (int(rng.integers(0, 64)), int(rng.integers(300, BUF_LEN + 1)))
    got = parse._parse_block_bytes(torch.from_numpy(rows), *owned,
                                   weighted=weighted, base=1)
    _assert_bytes_equal(got, _jax_bytes(rows, owned, weighted, 1), weighted)


def test_long_line_inside_one_block():
    """A line longer than the 64-byte overlap, wholly inside a block, parses
    (the kernel walks back to the previous newline, any distance)."""
    long_line = b"17" + b" " * 150 + b"42 " + b"0" * 20 + b"3.25\n"
    rows = _rows([b"1 2\n" + long_line + b"5 6\n", long_line])
    got = parse._parse_block_bytes(torch.from_numpy(rows), 64, BUF_LEN,
                                   weighted=True, base=0)
    want = _jax_bytes(rows, (64, BUF_LEN), True, 0)
    _assert_bytes_equal(got, want, True)
    v = got[0][0]
    assert got[1][0][v].tolist() == [17, 5]
    assert got[3][0][v].tolist() == [3.25, 1.0]


@pytest.mark.parametrize("weighted", [False, True])
def test_parse_blocks_matches_reference(weighted):
    rng = np.random.default_rng(5)
    rows = _rows([_random_text(rng, 30, weighted) for _ in range(3)])
    cap = BUF_LEN // 4 + 2
    ref = jparse.parse_blocks(jnp.asarray(rows), jnp.zeros(3, jnp.int32),
                              jnp.full(3, BUF_LEN, jnp.int32),
                              weighted=weighted, base=1, edge_cap=cap)
    got = parse.parse_blocks(torch.from_numpy(rows), 0, BUF_LEN,
                             weighted=weighted, base=1, edge_cap=cap)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            assert np.array_equal(g.numpy().view(np.int32),
                                  np.asarray(r).view(np.int32))
    one = parse.parse_block(torch.from_numpy(rows[1]), 0, BUF_LEN,
                            weighted=weighted, base=1, edge_cap=cap)
    assert np.array_equal(one[0].numpy(), np.asarray(ref[0][1]))
    assert int(one[3]) == int(ref[3][1])


@pytest.mark.parametrize("weighted", [False, True])
def test_parse_accumulate_multi_batch_matches_reference(weighted):
    """Two full batches plus a remainder tail pack exactly as the
    reference's fused step packs them."""
    rng = np.random.default_rng(11)
    batches = [_rows([_random_text(rng, 35, weighted) for _ in range(nb)])
               for nb in (2, 2, 1)]
    edge_cap = BUF_LEN // 4 + 2
    cap = 5 * edge_cap
    ref = jparse.make_accumulators(cap, weighted=weighted)
    got = parse.make_accumulators(cap, weighted=weighted, device="cpu")
    for rows in batches:
        nb = rows.shape[0]
        ref = jparse.parse_accumulate(
            *ref, jnp.asarray(rows), jnp.full(nb, 64, jnp.int32),
            jnp.full(nb, BUF_LEN, jnp.int32), weighted=weighted, base=1,
            edge_bound=nb * edge_cap, donate=False)
        got = parse.parse_accumulate(
            *got, torch.from_numpy(rows), 64, BUF_LEN, weighted=weighted,
            base=1, edge_bound=nb * edge_cap)
    assert int(got[3]) == int(ref[3]) > 0
    assert got[3].dtype == torch.int32
    for g, r in zip(got[:3], ref[:3]):
        if r is None:
            assert g is None
        else:
            assert np.array_equal(g.numpy().view(np.int32),
                                  np.asarray(r).view(np.int32))


def test_make_accumulators_layout():
    s, d, w, t = parse.make_accumulators(0, weighted=True, device="cpu")
    assert s.tolist() == [-1] and d.tolist() == [-1] and w.tolist() == [0.0]
    assert t.dtype == torch.int32 and t.shape == () and int(t) == 0


# ---- staging -----------------------------------------------------------------

def _data(rng, n):
    return np.frombuffer(_random_text(rng, n, True), np.uint8)


@pytest.mark.parametrize("ids", [[0], [0, 1, 2], [3, 4], [6, 7]])
def test_stage_blocks_matches_reference(ids):
    rng = np.random.default_rng(3)
    data = _data(rng, 120)
    plan = blocks.plan_blocks(len(data), beta=256, overlap=64)
    jplan = jblocks.plan_blocks(len(data), beta=256, overlap=64)
    ids = [i for i in ids if i < plan.num_blocks]
    flat = blocks.stage_blocks(data, plan, np.asarray(ids))
    want = jblocks.stage_blocks(data, jplan, np.asarray(ids))
    assert len(flat) == blocks.flat_len(len(ids), plan)
    assert np.array_equal(blocks.block_view(flat, plan), want)


def test_sequential_source_matches_memory_source():
    rng = np.random.default_rng(4)
    data = _data(rng, 200)
    plan = blocks.plan_blocks(len(data), beta=200, overlap=64)
    chunks = [data[i:i + 77].tobytes() for i in range(0, len(data), 77)]
    seq = blocks.SequentialBlockSource(iter(chunks), len(data))
    mem = blocks.MemoryBlockSource(data)
    arena = blocks.StagingArena(blocks.flat_len(3, plan))
    for lo in range(0, plan.num_blocks, 3):
        ids = np.arange(lo, min(lo + 3, plan.num_blocks))
        got = seq.stage(plan, ids, arena=arena.slot(lo), check_lines=True)
        assert np.array_equal(got, mem.stage(plan, ids))
    seq.finish()
    short = blocks.SequentialBlockSource(iter(chunks[:-1]), len(data))
    short.stage(plan, np.arange(plan.num_blocks))
    with pytest.raises(ValueError, match="decompressed to"):
        short.finish()


def test_overlong_line_across_block_raises():
    data = np.frombuffer(b"1 2\n" + b"9" * 300 + b" 3\n", np.uint8)
    plan = blocks.plan_blocks(len(data), beta=128, overlap=64)
    with pytest.raises(ValueError, match="overlap=64"):
        blocks.stage_blocks(data, plan, np.arange(plan.num_blocks),
                            check_lines=True)


class _Event:
    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_arena_slot_waits_for_its_fence_before_refill():
    arena = blocks.StagingArena(64, slots=2)
    a = arena.slot(0).take(32)
    ev = _Event()
    arena.fence(0, ev)
    b = arena.slot(1).take(32)
    assert ev.waited == 0 and not np.shares_memory(a, b)
    again = arena.slot(2).take(32)          # batch 2 reuses batch 0's slot
    assert ev.waited == 1 and np.shares_memory(a, again)
    arena.slot(2).take(32)                  # the fence is consumed once
    assert ev.waited == 1
    big = arena.slot(1).take(100)           # grows on demand
    assert big.size == 100
