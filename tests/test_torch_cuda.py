"""The port's CUDA kernels held against their plain PyTorch versions, on the
card, and the port's products (loads, walks, snapshots, the cache, the
sharded load, the serving engine and runtime) against their CPU runs.

Every test here is marked ``cuda`` and skips unless a CUDA device of
capability >= 9.0 is present; the module imports neither jax nor the JAX
package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer results and float weights (by bit pattern) are compared bitwise.
"""
import copy
import gzip

import numpy as np
import pytest
import torch

import repro_torch
import torch_inputs as ti
import torch_lm
from repro_torch import kernels
from repro_torch.core import CSR, parse
from repro_torch.core.build import csr_np
from repro_torch.data import prng, walks
from repro_torch.data.corpus import CorpusConfig, WalkCorpus

pytestmark = pytest.mark.cuda

# the kernels a load runs; neighbor_gather serves the CSR's consumers
LOAD_KERNELS = ("parse_accumulate", "exclusive_scan", "degree_histogram")


def _oracle(src, dst, w, v):
    """(offsets, targets, weights) of the port's host oracle."""
    o = csr_np(src, dst, w, v)
    return o.offsets, o.targets, o.weights


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _text(rng, nbytes, weighted=True):
    lines, size = [], 0
    while size < nbytes:
        line = f"{rng.integers(0, 10**9)} {rng.integers(0, 10**6)}"
        if weighted:
            line += f" {rng.normal() * 1e3:.{rng.integers(0, 5)}f}"
        if rng.random() < 0.05:
            line = "# " + line
        lines.append(line)
        size += len(line) + 1
    return ("\n".join(lines) + "\n").encode()


def _flat(rng, n):
    flat = np.full(n, 10, np.uint8)
    b = np.frombuffer(_text(rng, n), np.uint8)[:n]
    flat[:len(b)] = b
    return flat


def _assert_bytes_equal(got, want, weighted):
    v = want[0]
    assert torch.equal(got[0], v)
    assert torch.equal(got[1][v], want[1][v])
    assert torch.equal(got[2][v], want[2][v])
    if weighted:
        assert torch.equal(got[3][v].view(torch.int32),
                           want[3][v].view(torch.int32))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("base", [0, 1])
def test_parse_bytes_strided_span(cuda_device, weighted, base):
    rng = np.random.default_rng(1 + base)
    beta, overlap, nb = 4096, 64, 5
    flat = torch.from_numpy(_flat(rng, (nb - 1) * beta + beta + overlap))
    span = flat.to(cuda_device)
    bufs = span.as_strided((nb, beta + overlap), (beta, 1))
    kernels.reset_launches()
    got = kernels.parse_bytes(bufs, overlap, overlap + beta,
                              weighted=weighted, base=base)
    assert kernels.LAUNCHES["parse_bytes"] == 1
    want = kernels.parse_bytes_ref(bufs, overlap, overlap + beta,
                                   weighted=weighted, base=base)
    torch.cuda.synchronize()
    _assert_bytes_equal(got, want, weighted)
    cpu = kernels.parse_bytes(flat.as_strided((nb, beta + overlap),
                                              (beta, 1)),
                              overlap, overlap + beta, weighted=weighted,
                              base=base)
    _assert_bytes_equal([t.cpu() if t is not None else None for t in got],
                        cpu, weighted)


def test_parse_bytes_hazards(cuda_device):
    text = (b"12345678901 2\n1 2 123456789.123\n3 4 1.2.5\n1 2 7-2\n"
            b"1 2 -\n5 6\n# c 1 2\n1 2 3 4\n7 8\r\n\t9\t10  2.50 \n"
            b"abc\n1 x 2\n\n.\n-\n5" + b" " * 100 + b"6 0.5\n")
    rows = np.full((1, 512), 10, np.uint8)
    rows[0, :len(text)] = np.frombuffer(text, np.uint8)
    bufs = torch.from_numpy(rows)
    want = kernels.parse_bytes(bufs, 0, 512, weighted=True, base=1)
    got = kernels.parse_bytes(bufs.to(cuda_device), 0, 512, weighted=True,
                              base=1)
    _assert_bytes_equal([t.cpu() for t in got], want, True)


@pytest.mark.parametrize("owned", [ti.OWNED, (0, ti.ROW_LEN),
                                   (100, ti.ROW_LEN - 37)])
@pytest.mark.parametrize("weighted", [False, True])
def test_parse_bytes_tile_rows(cuda_device, weighted, owned):
    """The tile design's hazards (``tests/torch_inputs.py``), as rows and
    as the loader's aliased span."""
    rows = ti.tile_rows(2, weighted)
    span = torch.from_numpy(ti.flat_span(rows))
    for flat, shape in ((torch.from_numpy(rows), None),
                        (span, (ti.BETA, 1))):
        want = kernels.parse_bytes(
            flat if shape is None else flat.as_strided(rows.shape, shape),
            *owned, weighted=weighted, base=1)
        card = flat.to(cuda_device)
        got = kernels.parse_bytes(
            card if shape is None else card.as_strided(rows.shape, shape),
            *owned, weighted=weighted, base=1)
        _assert_bytes_equal([t.cpu() if t is not None else None
                             for t in got], want, weighted)


def _garbage(cap, seed, weighted, device):
    s, d, w = ti.garbage_accumulators(cap, seed, weighted)
    return (torch.from_numpy(s).to(device), torch.from_numpy(d).to(device),
            None if w is None else torch.from_numpy(w).to(device))


@pytest.mark.parametrize("weighted", [False, True])
def test_parse_accumulate_tile_rows_match_cpu(cuda_device, weighted):
    """Three batches of two aliased rows into garbage accumulators, from a
    non-zero total, 20 times over: bitwise the CPU path each time, one
    launch per batch, and the input total left as it was."""
    rows = ti.tile_rows(4, weighted)
    span = torch.from_numpy(ti.flat_span(rows))
    bound = 2 * (ti.ROW_LEN // 4 + 2)
    cap = 11 + 3 * bound + 50
    batches = [span[lo * ti.BETA:(lo + 1) * ti.BETA + ti.ROW_LEN]
               for lo in (0, 2, 4)]

    def run(device):
        acc = (*_garbage(cap, 4, weighted, device),
               torch.tensor(11, dtype=torch.int32, device=device))
        for flat in batches:
            bufs = flat.to(device).as_strided((2, ti.ROW_LEN), (ti.BETA, 1))
            before = acc[3]
            acc = kernels.parse_accumulate(*acc, bufs, *ti.OWNED,
                                           weighted=weighted, base=1,
                                           edge_bound=bound)
            assert int(before) <= int(acc[3])
        return [t.cpu() for t in acc if t is not None]

    want = run("cpu")
    for _ in range(20):
        kernels.reset_launches()
        got = run(cuda_device)
        assert kernels.LAUNCHES["parse_accumulate"] == 3
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("bound", [0, 37])
def test_parse_accumulate_drops_past_edge_bound(cuda_device, bound):
    rows = torch.from_numpy(ti.tile_rows(5, True)[:2])
    outs = []
    for device in ("cpu", cuda_device):
        acc = (*_garbage(200, 5, True, device),
               torch.tensor(3, dtype=torch.int32, device=device))
        acc = kernels.parse_accumulate(*acc, rows.to(device), *ti.OWNED,
                                       weighted=True, base=1,
                                       edge_bound=bound)
        outs.append([t.cpu() for t in acc])
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_csr_offsets_returns_the_scan_buffer(cuda_device, monkeypatch):
    deg = torch.from_numpy(ti.scan_input(10000, 7)).to(cuda_device)
    want = kernels.csr_offsets(deg.cpu())

    def no_cat(*args, **kwargs):
        raise AssertionError("csr_offsets copied through torch.cat")
    monkeypatch.setattr(torch, "cat", no_cat)
    got = kernels.csr_offsets(deg)
    assert got.shape == (10001,) and got.untyped_storage().nbytes() == 40004
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, ti.SCAN_TILE - 1,
                               ti.SCAN_TILE, ti.SCAN_TILE + 1, 1 << 20,
                               1 << 22, 1 << 26])
def test_exclusive_scan(cuda_device, n):
    """One kernel per call writes the prefix and the total into one
    ``(N+1,)`` buffer; 20 calls in a row, each bitwise (a stale look-back
    read would show as a tile off by one tile's sum now and then)."""
    x = torch.from_numpy(ti.scan_input(n, n, wrap=n > 4096)).to(cuda_device)
    w_excl, w_total = kernels.exclusive_scan_ref(x)
    for _ in range(20):
        kernels.reset_launches()
        excl, total = kernels.exclusive_scan(x)
        assert kernels.LAUNCHES["exclusive_scan"] == 1
        assert torch.equal(excl, w_excl) and torch.equal(total, w_total)
        assert total.data_ptr() == excl.data_ptr() + 4 * n


def test_exclusive_scan_wraps(cuda_device):
    x = torch.full((5000,), 2**30, dtype=torch.int32, device=cuda_device)
    excl, total = kernels.exclusive_scan(x)
    w_excl, w_total = kernels.exclusive_scan_ref(x.cpu())
    assert torch.equal(excl.cpu(), w_excl)
    assert torch.equal(total.cpu(), w_total)


def test_empty_inputs_do_not_launch(cuda_device):
    kernels.reset_launches()
    excl, total = kernels.exclusive_scan(
        torch.zeros(0, dtype=torch.int32, device=cuda_device))
    assert excl.shape == (0,) and int(total) == 0
    deg = kernels.degree_histogram(
        torch.zeros(0, dtype=torch.int32, device=cuda_device),
        num_vertices=4)
    assert deg.tolist() == [0, 0, 0, 0]
    assert set(kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("e,v", [(1, 1), (100000, 1000), (1 << 20, 17)])
def test_degree_histogram(cuda_device, e, v):
    src = torch.randint(-1, v + 3, (e,), dtype=torch.int32,
                        device=cuda_device)
    got = kernels.degree_histogram(src, num_vertices=v)
    assert torch.equal(got, kernels.degree_histogram_ref(src,
                                                         num_vertices=v))


def test_parse_accumulate_matches_cpu(cuda_device):
    rng = np.random.default_rng(2)
    rows = np.stack([_flat(rng, 2048) for _ in range(3)])
    bound = 3 * (2048 // 4 + 2)
    outs = []
    for dev in ("cpu", cuda_device):
        acc = parse.make_accumulators(bound, weighted=True, device=dev)
        acc = parse.parse_accumulate(
            *acc, torch.from_numpy(rows).to(dev), 0, 2048, weighted=True,
            base=1, edge_bound=bound)
        outs.append([t.cpu() for t in acc])
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("method", ["staged", "global", "binned"])
@pytest.mark.parametrize("codec", ["raw", "gzip"])
def test_load_csr_on_the_card(cuda_device, tmp_path, method, codec):
    rng = np.random.default_rng(3)
    v, e = 5000, 60000
    s = rng.integers(0, v, e).astype(np.int32)
    d = rng.integers(0, v, e).astype(np.int32)
    wi = rng.integers(0, 10**6, e)
    text = "".join(f"{a + 1} {b + 1} {c // 10**4}.{c % 10**4:04d}\n"
                   for a, b, c in zip(s, d, wi)).encode()
    path = tmp_path / ("g.el" if codec == "raw" else "g.el.gz")
    path.write_bytes(text if codec == "raw" else gzip.compress(text, 1))
    kernels.reset_launches()
    got = repro_torch.open_graph(str(path), weighted=True, beta=4096,
                                 batch_blocks=3).csr(method=method)
    assert got.targets.is_cuda and got.offsets.is_cuda
    assert min(kernels.LAUNCHES[k] for k in LOAD_KERNELS) > 0
    w = wi.astype(np.float32) / np.float32(10**4)
    want = csr_np(s, d, w, int(max(s.max(), d.max())) + 1)
    host = CSR(got.offsets.cpu(), got.targets.cpu(), got.weights.cpu(),
               got.num_vertices).numpy()
    assert host.num_vertices == want.num_vertices
    assert np.array_equal(host.offsets, want.offsets)
    assert np.array_equal(host.targets, want.targets)
    assert np.array_equal(host.weights.view(np.int32),
                          want.weights.view(np.int32))


def _random_csr(rng, v, e, hot=None):
    src = rng.integers(0, v, e)
    if hot is not None:
        src[: e // 2] = hot
    off = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=v))])
    return (torch.from_numpy(off.astype(np.int64)),
            torch.from_numpy(rng.integers(0, v, e).astype(np.int32)))


@pytest.mark.parametrize("v,e,width,hot", [
    (4, 10, 8, None), (9, 5, 16, None), (300, 5000, 32, 7),
    (100000, 1 << 20, 128, 3)])
def test_neighbor_gather(cuda_device, v, e, width, hot):
    rng = np.random.default_rng(v + width)
    off, tgt = _random_csr(rng, v, e, hot)
    ids = torch.from_numpy(np.concatenate([
        rng.integers(0, v, 4096), np.arange(-v - 3, min(v + 4, 4096)),
        [-2**31, -2**31 + 1, 2**31 - 2, 2**31 - 1]]).astype(np.int32))
    want = kernels.neighbor_gather_ref(ids, off, tgt, width=width)
    for offsets in (off, off.int()):
        kernels.reset_launches()
        got = kernels.neighbor_gather(ids.to(cuda_device),
                                      offsets.to(cuda_device),
                                      tgt.to(cuda_device), width=width)
        assert kernels.LAUNCHES["neighbor_gather"] == 1
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


def test_neighbor_gather_empty_inputs_do_not_launch(cuda_device):
    kernels.reset_launches()
    ids = torch.tensor([0, 1, -1], dtype=torch.int32, device=cuda_device)
    zeros = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    nbrs, deg = kernels.neighbor_gather(
        ids, zeros, torch.zeros(0, dtype=torch.int32, device=cuda_device),
        width=4)
    assert nbrs.tolist() == [[-1] * 4] * 3 and deg.tolist() == [0, 0, 0]
    nbrs, _ = kernels.neighbor_gather(ids[:0], zeros, ids, width=4)
    assert nbrs.shape == (0, 4)
    assert kernels.LAUNCHES["neighbor_gather"] == 0


def test_walks_on_the_card_match_the_cpu(cuda_device):
    off, tgt = _random_csr(np.random.default_rng(4), 5000, 40000)
    key = prng.key(7)
    want = walks.random_walks(off, tgt, key, num_walks=300, length=12,
                              num_vertices=5000, walk_offset=9)
    got = walks.random_walks(off.to(cuda_device), tgt.to(cuda_device), key,
                             num_walks=300, length=12, num_vertices=5000,
                             walk_offset=9)
    assert got.is_cuda
    assert torch.equal(got.cpu(), want)


def test_point_reads_and_corpus_on_the_card(cuda_device, tmp_path):
    rng = np.random.default_rng(6)
    s = rng.integers(0, 700, 9000)
    d = rng.integers(0, 700, 9000)
    path = tmp_path / "g.el"
    path.write_text("".join(f"{a + 1} {b + 1}\n" for a, b in zip(s, d)))
    card = repro_torch.open_graph(str(path))
    host = repro_torch.open_graph(str(path), device="cpu")
    for u in (0, 17, 699):
        got = card.neighbors(u)
        assert got.is_cuda
        assert torch.equal(got.cpu(), host.neighbors(u))
        assert card.degree(u) == host.degree(u)
    part = card.csr(rows=(100, 200))
    assert torch.equal(part.targets.cpu(), host.csr(rows=(100, 200)).targets)
    cfg = CorpusConfig(batch=64, seq=10)
    a, b = WalkCorpus(card, cfg), WalkCorpus(host, cfg)
    with a.batches(2) as stream:
        for _ in range(3):
            step, batch = next(stream)
            assert batch["tokens"].is_cuda
            assert torch.equal(batch["tokens"].cpu(),
                               b.batch_at(step)["tokens"])


# ---------------------------------------------------------------------------
# the histogram's and the gather's tile hazards (``tests/torch_inputs.py``);
# every case of 2**20 ids or more runs 20 times in a row
# ---------------------------------------------------------------------------

def _hist_equal(src, v, times=1):
    want = kernels.degree_histogram_ref(src, num_vertices=v)
    for _ in range(times):
        kernels.reset_launches()
        got = kernels.degree_histogram(src, num_vertices=v)
        assert kernels.LAUNCHES["degree_histogram"] == 1
        assert got.shape == want.shape
        assert torch.equal(got, want)


def _times(n):
    return 20 if n >= 1 << 20 else 1


@pytest.mark.parametrize("e,v", [(9000, 61), (1 << 20, 5000),
                                 (1 << 22, 1 << 20)])
def test_degree_histogram_sorted_runs(cuda_device, e, v):
    """Runs that cross every thread-chunk, warp and tile boundary."""
    src = torch.from_numpy(ti.sorted_runs(e, v, e)).to(cuda_device)
    _hist_equal(src, v, _times(e))


@pytest.mark.parametrize("ident", [0, 4999, 5000, -1])
def test_degree_histogram_one_id_repeated(cuda_device, ident):
    """One id 2**24 times: valid, the last valid, V itself and -1."""
    src = torch.full((1 << 24,), ident, dtype=torch.int32,
                     device=cuda_device)
    _hist_equal(src, 5000, 20)


@pytest.mark.parametrize("e", [*ti.HIST_SIZES, 1 << 26])
@pytest.mark.parametrize("order", ["sorted", "stream"])
def test_degree_histogram_sizes(cuda_device, e, order):
    v = 1 << 22 if e == 1 << 26 else 301
    ids = ti.stream_ids(e, v, e)
    if order == "sorted":
        ids = np.sort(ids)
    _hist_equal(torch.from_numpy(ids).to(cuda_device), v, _times(e))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("e", [4097, 1 << 20])
def test_degree_histogram_storage_offset(cuda_device, offset, e):
    base = torch.from_numpy(ti.sorted_runs(e + offset, 3000, offset))
    view = base.to(cuda_device)[offset:]
    assert view.storage_offset() == offset
    _hist_equal(view, 3000, _times(e))


@pytest.mark.parametrize("rho", [1, 3, 4, 8])
@pytest.mark.parametrize("p", [4099, (1 << 18) + 3])
def test_degree_histogram_rows(cuda_device, rho, p):
    """``(rho, P)`` with ``P % 4 != 0``: rows that start at every 4-byte
    alignment, sorted, ending in the padding key V."""
    src = torch.from_numpy(ti.padded_partitions(rho, p, 2000, rho + p))
    _hist_equal(src.to(cuda_device), 2000, _times(rho * p))


def test_csr_staged_launches_the_histogram_once(cuda_device):
    rng = np.random.default_rng(8)
    src = torch.from_numpy(ti.sorted_runs(100003, 7000, 8))
    src = src[torch.from_numpy(rng.permutation(len(src)))]
    dst = torch.from_numpy(rng.integers(0, 7000, len(src)).astype(np.int32))
    want = csr_np(src.numpy(), dst.numpy(), None, 7000)
    from repro_torch.core import build
    for rho in (1, 3, 4, 8):
        kernels.reset_launches()
        offsets, targets, _ = build.csr_staged(
            src.to(cuda_device), dst.to(cuda_device), None, 7000, rho=rho)
        assert kernels.LAUNCHES["degree_histogram"] == 1
        assert kernels.LAUNCHES["exclusive_scan"] == 1
        assert kernels.LAUNCHES["staged_merge"] == 1
        assert np.array_equal(offsets.cpu().numpy(), want.offsets)
        assert np.array_equal(targets.cpu().numpy(), want.targets)


# ---- the staged build's pair sort and merge ---------------------------------


@pytest.mark.parametrize("n,bits", [(1, 1), (4097, 9), ((1 << 20) + 3, 24),
                                    ((1 << 20) + 3, 31), (1 << 22, 24)])
def test_sort_pairs_on_the_card_matches_the_cpu(cuda_device, n, bits):
    """CUB's pair sort against the plain version: keys with ties and bits
    above ``bits``, values their positions (so stability shows)."""
    rng = np.random.default_rng(n + bits)
    keys = torch.from_numpy(rng.integers(0, 2**31 - 1, n).astype(np.int32))
    keys[torch.from_numpy(rng.random(n) < 0.3)] = 5
    vals = torch.arange(n, dtype=torch.int32)
    want = kernels.sort_pairs_ref(keys.clone(), vals.clone(), keys, vals,
                                  bits=bits)
    card = [t.to(cuda_device) for t in (keys, vals, keys, vals)]
    got = kernels.sort_pairs(*card, bits=bits)
    assert all(g.data_ptr() in {c.data_ptr() for c in card} for g in got)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("weighted", [False, True])
def test_staged_merge_on_the_card_matches_the_cpu(cuda_device, weighted,
                                                  monkeypatch):
    """The merge kernel against its plain version on a staged build's own
    sorted pairs and table (padding, a hub, 2^20 + 5 edges)."""
    from repro_torch.core import build
    rng = np.random.default_rng(31)
    e, v, rho = (1 << 20) + 5, 5000, 4
    src = rng.integers(-1, v + 3, e).astype(np.int32)
    src[rng.random(e) < 0.3] = 17
    dst = rng.integers(0, v, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    calls = []
    real = build.staged_merge
    monkeypatch.setattr(build, "staged_merge", lambda *a, **kw: calls.append(
        (a, kw)) or real(*a, **kw))
    build.csr_staged(torch.from_numpy(src).to(cuda_device),
                     torch.from_numpy(dst).to(cuda_device),
                     torch.from_numpy(w).to(cuda_device), v, rho=rho,
                     weighted=weighted)
    (args, kw), = calls
    kernels.reset_launches()
    got = kernels.staged_merge(*args, **kw)
    assert kernels.LAUNCHES["staged_merge"] == 1
    want = kernels.staged_merge_ref(
        *[t.cpu() for t in args],
        **{k: None if t is None else t.cpu() for k, t in kw.items()})
    assert torch.equal(got[0].cpu(), want[0])
    if weighted:
        assert torch.equal(got[1].cpu().view(torch.int32),
                           want[1].view(torch.int32))


@pytest.mark.parametrize("case", ti.STAGED_CASES)
@pytest.mark.parametrize("rho", [1, 4, 7])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_staged_on_the_card_matches_the_cpu(cuda_device, case, rho,
                                                weighted):
    """Bitwise the CPU build on every shape the CPU tests hold against the
    reference; one histogram, one scan and one merge a build."""
    from repro_torch.core import build
    src, dst, w, v = ti.staged_edges(case, rho)
    args = [torch.from_numpy(a) for a in (src, dst, w)]
    if not weighted:
        args[2] = None
    want = build.csr_staged(*args, v, rho=rho, weighted=weighted)
    kernels.reset_launches()
    got = build.csr_staged(*[None if a is None else a.to(cuda_device)
                             for a in args], v, rho=rho, weighted=weighted)
    for g, t in zip(got, want):
        assert _same(g, t)
    assert kernels.LAUNCHES["degree_histogram"] == 1
    assert kernels.LAUNCHES["exclusive_scan"] == 1
    assert kernels.LAUNCHES["staged_merge"] == 1


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("spare", [0, 1 << 20])
def test_csr_staged_sorts_in_donated_card_buffers(cuda_device, weighted,
                                                  spare):
    """Donated buffers with no room past the edges, and with room for the
    sort's second buffers there: the undonated product, bitwise."""
    from repro_torch.core import build
    src, dst, w, v = ti.staged_edges("padding", 3)
    e = len(src)
    want = build.csr_staged(*[torch.from_numpy(a).to(cuda_device)
                              for a in (src, dst, w)], v, weighted=weighted)

    def grown(a):
        return torch.from_numpy(np.concatenate(
            [a, np.full(spare, 7, a.dtype)])).to(cuda_device)

    got = build.csr_staged(grown(src), grown(dst), grown(w), v,
                           weighted=weighted, num_edges=e, donate=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if weighted:
        assert torch.equal(got[2].view(torch.int32),
                           want[2].view(torch.int32))


def _rmat_file(tmp_path, scale):
    from repro_torch.core.generate import rmat_edges
    src, dst, v = rmat_edges(scale, 16, seed=scale)
    path = str(tmp_path / f"rmat{scale}.el")
    ti.write_text_fast(path, src, dst)
    return path, src, dst


def test_staged_load_of_an_rmat_file_matches_the_cpu(cuda_device, tmp_path):
    """A scale-16 RMAT file through ``open_graph(...).csr(method="staged")``
    on the card: the CPU load's CSR, bitwise, with one merge launch."""
    path, _, _ = _rmat_file(tmp_path, 16)
    kernels.reset_launches()
    got = repro_torch.open_graph(path).csr(method="staged")
    assert kernels.LAUNCHES["staged_merge"] == 1
    assert kernels.LAUNCHES["degree_histogram"] == 1
    assert kernels.LAUNCHES["exclusive_scan"] == 1
    _same_csr(got, repro_torch.open_graph(path, device="cpu").csr(
        method="staged"))


def test_staged_load_peak_memory_stays_within_the_design(cuda_device,
                                                         tmp_path):
    """A scale-20 ``staged`` load's peak above what was allocated before it
    stays within the accumulators, 12 B an edge (the targets, the sort's
    scratch, the feed) and (8 rho + 12) B a vertex (the degree and merge
    tables, the int32 offsets and their int64 copy): the sort runs in the
    accumulators, and no rank, destination or int64 index array exists."""
    import os
    from repro_torch.core import loader
    from repro_torch.core.blocks import plan_blocks
    path, src, dst = _rmat_file(tmp_path, 20)
    v = int(max(src.max(), dst.max())) + 1
    plan = plan_blocks(os.path.getsize(path), beta=loader.DEFAULT_BETA,
                       overlap=loader.DEFAULT_OVERLAP)
    accumulators = 8 * plan.num_blocks * plan.edge_cap
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    got = repro_torch.open_graph(path).csr(method="staged")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert int(got.offsets[-1]) == len(src)
    assert peak <= accumulators + 12 * len(src) + (8 * 4 + 12) * v, \
        (peak, accumulators, len(src), v)


@pytest.mark.parametrize("width", ti.GATHER_WIDTHS)
@pytest.mark.parametrize("b", [*ti.GATHER_BATCHES, 1 << 20])
def test_neighbor_gather_widths_and_groups(cuda_device, width, b):
    """Widths off and on the int4 path, batches around the group of 32,
    rows at every ``lo % 4``, a hot vertex of degree far above the width,
    int64 and int32 offsets."""
    v = 1 << 16 if b == 1 << 20 else 70
    off, tgt = ti.gather_csr(v, 40 * width * min(v, 4096), width, width)
    ids = torch.from_numpy(ti.gather_ids(v, b, b)).to(cuda_device)
    tgt = torch.from_numpy(tgt).to(cuda_device)
    for offsets in (off, off.astype(np.int32)):
        offsets = torch.from_numpy(offsets).to(cuda_device)
        want = kernels.neighbor_gather_ref(ids, offsets, tgt, width=width)
        for _ in range(_times(b)):
            kernels.reset_launches()
            got = kernels.neighbor_gather(ids, offsets, tgt, width=width)
            assert kernels.LAUNCHES["neighbor_gather"] == 1
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        del want, got


# ---- .gvel snapshots, framed text, MTX and symmetric=True on the card -------

def _same(a, b):
    """Bitwise equality of a card tensor and its CPU twin (or None)."""
    if a is None or b is None:
        return a is None and b is None
    return a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)


def _same_csr(got, want):
    assert got.num_vertices == want.num_vertices
    assert got.row_start == want.row_start
    assert _same(got.offsets, want.offsets) and _same(got.targets, want.targets)
    assert _same(got.weights, want.weights)


@pytest.fixture
def weighted_text(tmp_path):
    src, dst, w = ti.graph_edges(21, v=3000, e=40001, weighted=True,
                                 isolated=5)
    path = str(tmp_path / "g.el")
    ti.write_text(path, src, dst, w)
    return path


@pytest.mark.parametrize("compress", [None, "zlib:1"])
@pytest.mark.parametrize("sections", ["both", "edgelist", "csr"])
def test_snapshot_products_on_the_card(cuda_device, weighted_text, tmp_path,
                                       compress, sections):
    from repro_torch.core import snapshot
    host = repro_torch.open_graph(weighted_text, device="cpu", weighted=True,
                                  num_vertices=3000)
    path = str(tmp_path / "g.gvel")
    snapshot.save_snapshot(
        path, edgelist=None if sections == "csr" else host.edgelist(),
        csr=None if sections == "edgelist" else host.csr(),
        compress=None if compress is None else compress.split(":")[0],
        frame_beta=4096)
    cpu = repro_torch.open_graph(path, device="cpu")
    card = repro_torch.open_graph(path)
    kernels.reset_launches()
    if sections != "edgelist":
        _same_csr(card.csr(), cpu.csr())
    else:
        _same_csr(card.csr(method="staged", rho=3), cpu.csr(method="staged",
                                                            rho=3))
        # the edgelist-only snapshot streams its edges and builds on the card
        assert kernels.LAUNCHES["degree_histogram"] > 0
        assert kernels.LAUNCHES["exclusive_scan"] > 0
        (s, d, w, total), cap = card.stream()
        assert s.is_cuda and s.shape == (cap,) == (40001,)
        assert int(total) == 40001
    if sections != "csr":
        el, want = card.edgelist(), cpu.edgelist()
        assert _same(el.src, want.src) and _same(el.dst, want.dst)
        assert _same(el.weights, want.weights)
    for u in (0, 7, 2999):
        assert _same(card.neighbors(u), cpu.neighbors(u))
        ids, w = card.neighbors(u, with_weights=True)
        assert _same(w, cpu.neighbors(u, with_weights=True)[1])
        assert card.degree(u) == cpu.degree(u)
    _same_csr(card.csr(rows=(100, 250)), cpu.csr(rows=(100, 250)))
    assert card.frame_cache_stats() == cpu.frame_cache_stats()


def test_compressed_section_moves_through_the_pinned_ring(
        cuda_device, weighted_text, tmp_path, monkeypatch):
    """A zlib CSR section reaches the card chunk by chunk through pinned
    slots, each frame decoded once, and nothing stays decoded on the
    host."""
    from repro_torch.core import codecs, snapshot
    path = str(tmp_path / "g.gvel")
    host = repro_torch.open_graph(weighted_text, device="cpu", weighted=True)
    snapshot.save_snapshot(path, csr=host.csr(), compress="zlib",
                           frame_beta=4096)
    arenas, frames = [], []

    class Arena(snapshot.StagingArena):
        def __init__(self, nbytes, slots=2, pin=False):
            super().__init__(nbytes, slots, pin)
            arenas.append((nbytes, pin))

    real = codecs.decode_frame

    def spy(payload, entry, codec, **kw):
        frames.append((kw["context"], entry.index))
        return real(payload, entry, codec, **kw)
    monkeypatch.setattr(snapshot, "StagingArena", Arena)
    monkeypatch.setattr(snapshot, "CHUNK_BYTES", 8192)
    monkeypatch.setattr(codecs, "decode_frame", spy)
    monkeypatch.setattr(snapshot, "FRAME_CACHE_BYTES", 1 << 30)
    snap = snapshot.read_snapshot(path, eager=False)
    csr = snap.csr(cuda_device)
    seen = list(frames)              # the card load's decodes only
    want = repro_torch.open_graph(path, device="cpu").csr()
    assert _same(csr.targets, want.targets)
    assert _same(csr.offsets, want.offsets)
    assert _same(csr.weights, want.weights)
    # two 4 KiB frames a chunk, each chunk through a pinned slot
    assert arenas and all(pin and n == 8192 for n, pin in arenas)
    assert len(seen) == len(set(seen)) > 3
    assert snap.decoded_sections() == []
    assert snap.frame_cache_stats()["frames"] == 0


def test_framed_text_loads_on_the_card(cuda_device, weighted_text, tmp_path):
    from repro_torch.core import codecs
    framed = str(tmp_path / "g.elz")
    codecs.compress_file_framed(weighted_text, framed, codec="zlib",
                                frame_beta=8192)
    kernels.reset_launches()
    got = repro_torch.open_graph(framed, weighted=True).csr()
    assert min(kernels.LAUNCHES[k] for k in LOAD_KERNELS) > 0
    _same_csr(got, repro_torch.open_graph(weighted_text, device="cpu",
                                          weighted=True).csr())


@pytest.mark.parametrize("symmetric", [False, True])
def test_mtx_and_symmetric_loads_on_the_card(cuda_device, tmp_path,
                                             symmetric):
    src, dst, w = ti.graph_edges(22, v=2000, e=30001, weighted=True,
                                 loops=50)
    path = str(tmp_path / "g.mtx")
    with open(path, "w") as f:
        kind = "symmetric" if symmetric else "general"
        f.write(f"%%MatrixMarket matrix coordinate real {kind}\n")
        f.write(f"2000 2000 {len(src)}\n")
        for a, b, x in zip(src, dst, w):
            f.write(f"{a + 1} {b + 1} {float(x):.3f}\n")
    kernels.reset_launches()
    card = repro_torch.open_graph(path, symmetric=not symmetric)
    got = card.csr()
    assert kernels.LAUNCHES["degree_histogram"] > 0
    assert kernels.LAUNCHES["exclusive_scan"] > 0
    cpu = repro_torch.open_graph(path, device="cpu", symmetric=not symmetric)
    _same_csr(got, cpu.csr())
    el = card.edgelist()
    assert _same(el.src, cpu.edgelist().src)
    want = ti.mtx_expand(src, dst, w) if symmetric else \
        (np.concatenate([src, dst]), np.concatenate([dst, src]),
         np.concatenate([w, w]))
    off, tgt, ww = _oracle(*want, 2000)
    assert np.array_equal(got.targets.cpu().numpy(), tgt)
    assert got.weights.cpu().numpy().tobytes() == ww.tobytes()


@pytest.mark.parametrize("method", ["staged", "global", "binned"])
def test_convert_to_csr_and_save_on_the_card(cuda_device, weighted_text,
                                             tmp_path, method):
    from repro_torch.core import EdgeList, convert_to_csr
    cpu = repro_torch.open_graph(weighted_text, device="cpu", weighted=True)
    el = cpu.edgelist()
    card_el = EdgeList(el.src.to(cuda_device), el.dst.to(cuda_device),
                       el.weights.to(cuda_device), el.num_edges,
                       el.num_vertices)
    kernels.reset_launches()
    before = [t.clone() for t in (card_el.src, card_el.dst, card_el.weights)]
    got = convert_to_csr(card_el, method=method)
    assert kernels.LAUNCHES["degree_histogram"] > 0
    assert kernels.LAUNCHES["exclusive_scan"] > 0
    for t, b in zip((card_el.src, card_el.dst, card_el.weights), before):
        assert torch.equal(t.view(torch.int32), b.view(torch.int32))
    _same_csr(got, convert_to_csr(el, method=method))
    a, b = str(tmp_path / "card.gvel"), str(tmp_path / "cpu.gvel")
    out = repro_torch.open_graph(weighted_text, weighted=True).save(
        a, compress="zlib:1", method=method)
    cpu.save(b, compress="zlib:1", method=method)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert out.options.device.type == "cuda"


# ---- the serving cache and the fault plan on the card -------------------------


def test_two_streams_share_a_cached_csr(cuda_device, tmp_path):
    """A CSR built cold by one thread on its own stream is complete when
    another thread, on another stream, reads it from the cache."""
    import threading
    import torch_serving as ts
    from repro_torch.core.cache import SourceCache
    path, v, oracle = ts.text_file(tmp_path, "big", v=1 << 16, e=1 << 21)
    cache = SourceCache(capacity=2)
    built, results = threading.Event(), {}

    def build_first():
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            results["a"] = cache.query(path, "csr", num_vertices=v)
        built.set()

    def reader():
        built.wait(120)
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            csr = cache.query(path, "csr", num_vertices=v)
            # read on this stream at once, with no wait on the first thread
            results["b"] = (csr.offsets.clone(), csr.targets.clone(),
                            csr.degrees().sum())
            torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=build_first),
               threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    off, tgt, total = results["b"]
    assert results["a"].targets.is_cuda and off.is_cuda
    assert ts.same(off, oracle.offsets) and ts.same(tgt, oracle.targets)
    assert int(total) == 1 << 21
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 1


def test_cache_resolves_the_device_before_the_slot(cuda_device, tmp_path):
    import torch_serving as ts
    from repro_torch.core.cache import SourceCache
    gv, v, oracle = ts.snapshot_file(tmp_path, "g", compress=None)
    cache = SourceCache(capacity=8)
    torch.cuda.set_device(cuda_device)
    handles = [cache.get(gv, device=d) for d in
               (None, "cuda", "cuda:0", torch.device("cuda", 0))]
    assert all(h is handles[0] for h in handles)
    assert len(cache) == 1 and cache.stats()["misses"] == 1
    assert handles[0].options.device == torch.device("cuda", 0)
    assert cache.get(gv, device="cpu") is not handles[0]
    got = cache.query(gv, "neighbors", vertex=5, device="cuda:0")
    assert got.is_cuda and ts.same(got, oracle.targets[oracle.offsets[5]:
                                                       oracle.offsets[6]])


def test_frame_fault_during_the_pinned_ring_copy(cuda_device, weighted_text,
                                                 tmp_path, monkeypatch):
    """A frame fault inside the decode pool, mid-way through a section's
    chunked copy to the card, surfaces as the section's CorruptGraphError;
    the side stream is drained, and the next requests are served."""
    import os
    import shutil
    from repro_torch.core import faults, snapshot
    from repro_torch.core.cache import SourceCache
    host = repro_torch.open_graph(weighted_text, device="cpu", weighted=True,
                                  num_vertices=3000)
    path = str(tmp_path / "g.gvel")
    snapshot.save_snapshot(path, edgelist=host.edgelist(), csr=host.csr(),
                           compress="zlib", frame_beta=4096)
    monkeypatch.setattr(snapshot, "CHUNK_BYTES", 8192)
    where = f"{path} section {snapshot.SEC_CSR_INDICES}"
    plan = faults.FaultPlan([faults.FaultSpec("frame", "bitflip", index=9,
                                              path=where)], seed=1)
    cache = SourceCache(capacity=2)
    with faults.fault_plan(plan):
        with pytest.raises(faults.CorruptGraphError) as ei:
            cache.query(path, "csr")
    assert ei.value.section == "csr_indices" and ei.value.op == "csr"
    assert plan.injected() == {"frame:bitflip": 1}
    torch.cuda.synchronize()
    assert cache.query(path, "degree", vertex=7) == host.degree(7)
    assert cache.query(path, "info").num_vertices == 3000
    with pytest.raises(faults.CorruptGraphError, match="quarantined"):
        cache.query(path, "neighbors", vertex=7)
    shutil.copyfile(path, path + ".new")           # swap the same bytes in
    os.replace(path + ".new", path)
    _same_csr(cache.query(path, "csr"), host.csr())
    assert cache.stats()["faults"]["recovered"] == 1


def test_sharded_load_at_world_size_one_over_nccl(cuda_device, weighted_text,
                                                  tmp_path):
    """A world of one rank over NCCL: ``csr_sharded`` runs every stage on
    the card (the parse, the exchange, the local build's histogram and
    scan) and its rows are ``open_graph(p).csr()``'s, bitwise (that load
    run on the CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/world",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        kernels.reset_launches()
        src = repro_torch.open_graph(weighted_text, weighted=True,
                                     beta=8192)
        got = src.csr_sharded(mesh)
        assert min(kernels.LAUNCHES[k] for k in LOAD_KERNELS) > 0
        assert src.csr_sharded(mesh) is got
    finally:
        dist.destroy_process_group()
    want = repro_torch.open_graph(weighted_text, weighted=True,
                                  device="cpu").csr()
    v, e = want.num_rows, int(want.offsets[-1])
    assert got.offsets.is_cuda and got.offsets.dtype == torch.int32
    assert got.row_start == 0 and got.num_vertices == v
    assert _same(got.offsets[:v + 1].long(), want.offsets)
    assert _same(got.targets[:e], want.targets)
    assert _same(got.weights[:e], want.weights)
    assert bool((got.targets[e:] == -1).all())


def test_tuned_load_equals_the_default_load(cuda_device, weighted_text,
                                            tmp_path, monkeypatch):
    """``tune=True`` on a fresh profile sweeps on the card once, keeps the
    winner under the card's fingerprint, and loads the default's CSR."""
    import json
    from repro_torch.core import env, tune
    cache = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(cache))
    sweeps = []
    real = tune.run_sweep
    monkeypatch.setattr(tune, "run_sweep",
                        lambda *a, **k: sweeps.append(k) or real(*a, **k))
    tuned = repro_torch.open_graph(weighted_text, weighted=True,
                                   tune=True).csr()
    again = repro_torch.open_graph(weighted_text, weighted=True,
                                   tune=True).csr()
    assert len(sweeps) == 1 and sweeps[0]["device"] == cuda_device
    slots = json.loads(cache.read_text())["hosts"][env.fingerprint(
        cuda_device)]
    assert set(slots) == {"weighted"} and len(slots["weighted"]["sweep"]) == 9
    want = repro_torch.open_graph(weighted_text, weighted=True,
                                  device="cpu").csr()
    _same_csr(tuned, want)
    _same_csr(again, want)


# ---- the walk-LM serving path ---------------------------------------------------

def _cpu_and_card_models(cuda_device):
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    cfg = reduced_config("phi4-mini-3.8b")
    cpu = init_params(cfg, 3, device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(cuda_device)


def _hold_engines(card, cpu, card_logits, cpu_logits):
    """Token streams under the margin rule; each step's logits within
    ``COMPILED_TOL`` while the two requests' histories agree."""
    torch_lm.assert_streams_agree(card, cpu, cpu_logits)
    for rid, want in cpu.items():
        for j, (a, b) in enumerate(zip(card_logits[rid], cpu_logits[rid])):
            np.testing.assert_allclose(a, b, rtol=torch_lm.COMPILED_TOL,
                                       atol=torch_lm.COMPILED_TOL)
            if card[rid][j] != want[j]:
                break


def test_serve_engine_on_the_card_matches_the_cpu(cuda_device):
    """The reduced phi4-mini engine on the card against the port's CPU run
    of the same weights, with the CPU parity test's tolerance and margin
    rule (tests/torch_lm.py)."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, cpu_model, card_model = _cpu_and_card_models(cuda_device)
    rng = np.random.default_rng(11)
    specs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 10)))
              .astype(np.int32), int(rng.integers(1, 10))) for _ in range(11)]
    engines = [ServeEngine(cfg, cpu_model, batch=3, max_seq=48, device="cpu"),
               ServeEngine(cfg, card_model, batch=3, max_seq=48,
                           device=cuda_device)]
    logits = [torch_lm.record_tick_logits(e) for e in engines]
    for eng in engines:
        for i, (prompt, new) in enumerate(specs):
            eng.submit(Request(i, prompt, new))
        eng.run()
    cpu, card = ({r.rid: r.out for r in e.completed} for e in engines)
    assert [r.slot for r in engines[0].completed] == \
        [r.slot for r in engines[1].completed]
    _hold_engines(card, cpu, logits[1], logits[0])


def test_serve_runtime_on_the_card(cuda_device, weighted_text, tmp_path):
    """ServeRuntime on the card over a text graph and its snapshot: the
    text's first request runs the loader's kernels, prompts equal the CPU
    runtime's bitwise, token streams agree under the margin rule."""
    from repro_torch.core.cache import SourceCache
    from repro_torch.serve.runtime import ServeRuntime
    cfg, cpu_model, card_model = _cpu_and_card_models(cuda_device)
    snap = str(tmp_path / "g.gvel")
    repro_torch.open_graph(weighted_text, weighted=True,
                           device="cpu").save(snap)
    runs = []
    for model, device in ((cpu_model, "cpu"), (card_model, cuda_device)):
        rt = ServeRuntime(cfg, model, batch=3, max_seq=32,
                          cache=SourceCache(capacity=2), seed=5,
                          device=device)
        logits = torch_lm.record_tick_logits(rt.engine)
        kernels.reset_launches()
        reqs = [rt.submit(snap, max_new=4)]
        reqs.append(rt.submit(weighted_text, max_new=5, weighted=True))
        if torch.device(device).type == "cuda":
            assert all(kernels.LAUNCHES[k] > 0 for k in LOAD_KERNELS)
        reqs += [rt.submit((snap, weighted_text)[i % 2], max_new=3,
                           **({"weighted": True} if i % 2 else {}))
                 for i in range(4)]
        rt.drain()
        assert all(r.done for r in reqs)
        runs.append((reqs, logits))
    (cpu, cpu_logits), (card, card_logits) = runs
    for a, b in zip(card, cpu):
        assert np.array_equal(a.prompt, b.prompt), a.rid
    _hold_engines({r.rid: r.out for r in card}, {r.rid: r.out for r in cpu},
                  card_logits, cpu_logits)



# ---- the remaining serving kinds at reduced width ---------------------------------

KIND_CASES = {
    # MoE at the published capacity factors, so that tokens drop
    "mixtral-8x22b": {"capacity_factor": 1.25},
    "llama4-maverick-400b-a17b": {"capacity_factor": 2.0},
    "recurrentgemma-2b": None, "falcon-mamba-7b": None,
    "llama-3.2-vision-11b": None, "musicgen-large": None}


def _run_kind(model, cfg, batch, steps, device):
    from repro_torch.models import forward_decode, forward_prefill
    batch = {k: v.to(device) for k, v in batch.items()}
    plen = next(iter(batch.values())).shape[1]
    with torch.inference_mode():
        lg, caches = forward_prefill(model, batch, cfg, 32)
        out = [(lg.float().cpu(), [{k: c[k].float().cpu() for k in c}
                                   for c in caches])]
        for i, tok in enumerate(steps):
            lg, caches = forward_decode(
                model, {"token": tok.to(device),
                        "pos": torch.full((len(tok),), plen + i,
                                          dtype=torch.int32, device=device)},
                caches, cfg, 32)
            out.append((lg.float().cpu(), [{k: c[k].float().cpu() for k in c}
                                           for c in caches]))
    return out


@pytest.mark.parametrize("name", sorted(KIND_CASES))
def test_serving_kind_on_the_card_matches_the_cpu(cuda_device, name):
    """Each serving kind's reduced arch (MoE at the published capacity, a
    recurrent prefill and decode, the VLM with ``image_embeds``, musicgen
    with ``frames``) on the card against the same weights on the CPU:
    prefill and four decode steps, logits and every cache leaf within
    ``COMPILED_TOL``."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    cfg = reduced_config(name)
    if KIND_CASES[name]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **KIND_CASES[name]))
    cpu = init_params(cfg, 3, device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    g = torch.Generator().manual_seed(4)
    batch = ({"frames": torch.randn((2, 7, cfg.d_model), generator=g)}
             if cfg.embed_stub else
             {"tokens": torch.randint(0, cfg.vocab_size, (2, 7), generator=g,
                                      dtype=torch.int32)})
    if "xattn" in cfg.layer_pattern:
        batch["image_embeds"] = torch.randn(
            (2, cfg.num_image_tokens, cfg.d_model), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (4, 2), generator=g,
                          dtype=torch.int32)
    got = _run_kind(card, cfg, batch, steps, cuda_device)
    want = _run_kind(cpu, cfg, batch, steps, "cpu")
    tol = torch_lm.COMPILED_TOL
    for step, ((lg, cs), (wlg, wcs)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(lg.numpy(), wlg.numpy(), rtol=tol,
                                   atol=tol, err_msg=f"logits step {step}")
        for layer, (c, wc) in enumerate(zip(cs, wcs)):
            assert sorted(c) == sorted(wc)
            for k in c:
                np.testing.assert_allclose(
                    c[k].numpy(), wc[k].numpy(), rtol=tol, atol=tol,
                    err_msg=f"{k} layer {layer} step {step}")


# ---- training ---------------------------------------------------------------------

TRAIN_KINDS = ["phi4-mini-3.8b", "mixtral-8x22b", "recurrentgemma-2b",
               "falcon-mamba-7b", "llama-3.2-vision-11b", "musicgen-large"]


@pytest.mark.parametrize("name", TRAIN_KINDS)
def test_training_step_of_each_kind_on_the_card_matches_the_cpu(cuda_device,
                                                                name):
    """One loss's gradients and one training step of each kind's reduced
    arch on the card against the same f32 weights and batch on the CPU:
    each leaf's gradient within 5e-2 of its largest magnitude, the loss at
    2e-3 and the gradient norm at 1e-2 relative, and the params after one
    AdamW step of lr 1e-3 within 2.5e-3 (Adam's first update is near ``lr
    * sign(g)``, so an element whose gradient is near 0 may step the other
    way)."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    cfg = reduced_config(name)
    cpu = init_params(cfg, 3, device="cpu", dtype=torch.float32)
    card = copy.deepcopy(cpu).to(cuda_device)
    assert all(p.requires_grad and p.is_cuda for p in card.parameters())
    batch = synthetic_batch(cfg, 4, 32, 0, device="cpu")
    grads = []
    for model, dev in ((card, cuda_device), (cpu, "cpu")):
        loss_fn(model, {k: v.to(dev) for k, v in batch.items()}, cfg,
                "full").backward()
        grads.append({n: p.grad.detach().cpu()
                      for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    for n, g in grads[1].items():
        assert float((grads[0][n] - g).abs().max()) <= \
            5e-2 * float(g.abs().max()), n
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=0,
                                                decay_steps=100))
    s_card, m_card = step(init_state(card), batch)
    s_cpu, m_cpu = step(init_state(cpu), batch)
    assert s_card.step.is_cuda and int(s_card.step) == 1
    np.testing.assert_allclose(float(m_card["loss"]), float(m_cpu["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(m_card["grad_norm"]),
                               float(m_cpu["grad_norm"]), rtol=1e-2)
    for a, b in zip(s_card.params.parameters(), s_cpu.params.parameters()):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), rtol=0, atol=2.5e-3)


def test_checkpoint_round_trip_from_the_card(cuda_device, tmp_path):
    """A state trained on the card, checkpointed, restores bitwise into a
    state on the CPU and into one on the card."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    cfg = reduced_config("phi4-mini-3.8b")

    def fresh(seed, device):
        return init_state(init_params(cfg, seed, device=device,
                                      dtype=torch.float32), compression=True)

    state = fresh(1, cuda_device)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                decay_steps=50),
                           compression=True)
    for i in range(2):
        state, _ = step(state, synthetic_batch(cfg, 4, 16, i,
                                               device=cuda_device))
    ckpt_io.save(state, str(tmp_path), 2, async_=True).join()
    assert ckpt_io.latest_step(str(tmp_path)) == 2
    for device in ("cpu", cuda_device):
        got, at = ckpt_io.restore(fresh(5, device), str(tmp_path))
        assert at == 2 and int(got.step) == 2
        mine, want = ckpt_io._flatten(got), ckpt_io._flatten(state)
        assert sorted(mine) == sorted(want)
        for k, v in want.items():
            pairs = [(mine[k][j], v[j]) for j in v] \
                if isinstance(v, dict) else [(mine[k], v)]
            for a, b in pairs:
                assert a.device.type == torch.device(device).type
                assert torch.equal(a.detach().cpu(), b.detach().cpu()), k


def test_zero1_step_in_an_nccl_world_of_one(cuda_device, tmp_path):
    """The ZeRO-1 step (``DTensor`` moments on the card, NCCL's
    reduce-scatter and all-gather) and the int8 step, each in a world of
    one, against ``make_train_step`` from the same weights on the same
    batch: the losses within 1e-5, the gradient norms within 1e-3 (the
    int8 one within 2e-3: two quantizations), the params after two steps
    within rtol 5e-3, atol 5e-5 (ZeRO-1)."""
    import torch.distributed as dist
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import (make_local_accum_train_step,
                                        make_train_step,
                                        make_zero1_local_state)
    cfg = reduced_config("phi4-mini-3.8b")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=50)
    batch = synthetic_batch(cfg, 8, 32, 0, device=cuda_device)
    base = init_params(cfg, 0, device=cuda_device, dtype=torch.float32)
    want = init_state(copy.deepcopy(base))
    single = make_train_step(cfg, oc, accum_steps=2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/world",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        zstate = make_zero1_local_state(copy.deepcopy(base), 1, mesh=mesh)
        qstate = init_state(copy.deepcopy(base))
        zstep = make_local_accum_train_step(cfg, oc, mesh, accum_steps=2,
                                            zero1=True)
        qstep = make_local_accum_train_step(cfg, oc, mesh, accum_steps=2,
                                            int8_allreduce=True)
        for _ in range(2):
            want, mw = single(want, batch)
            zstate, mz = zstep(zstate, batch)
            qstate, mq = qstep(qstate, batch)
            for m, gtol in ((mz, 1e-3), (mq, 2e-3)):
                np.testing.assert_allclose(float(m["loss"]),
                                           float(mw["loss"]), rtol=1e-5)
                np.testing.assert_allclose(float(m["grad_norm"]),
                                           float(mw["grad_norm"]), rtol=gtol)
        assert all(v.to_local().is_cuda for v in zstate.mu.values())
        for a, b in zip(zstate.params.parameters(), want.params.parameters()):
            np.testing.assert_allclose(a.detach().cpu().numpy(),
                                       b.detach().cpu().numpy(), rtol=5e-3,
                                       atol=5e-5)
    finally:
        dist.destroy_process_group()


def test_tensor_parallel_on_the_card(cuda_device, tmp_path):
    """A ``(1, 2)`` gloo world, both ranks on this card
    (``tests/torch_tp_world.py``'s ``card`` case): the reduced phi4-mini's
    sharded loss within ``LOSS_RTOL`` (5e-4) and its prefill and decode
    logits within ``TOL`` (2e-2, tests/torch_models_ref.py) of the
    unsharded run of the same parameters on the card, on both ranks."""
    import json
    import os
    import sys
    from repro_torch.scripts import local_world
    here = os.path.dirname(os.path.abspath(__file__))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"mesh": [1, 2], "device": "cuda",
                                "cases": ["card"]}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here]))
    runs = local_world.spawn([sys.executable,
                              os.path.join(here, "torch_tp_world.py"),
                              str(spec), str(tmp_path)], 2, timeout=300,
                             env=env, workdir=str(tmp_path))
    for k, run in enumerate(runs):
        assert run.returncode == 0, f"rank {k}:\n{run.stdout}{run.stderr}"
        errors = json.loads((tmp_path / f"rank{k}.json").read_text())
        assert not errors["errors"], errors
        got = dict(np.load(tmp_path / f"card_{k}.npz"))
        np.testing.assert_allclose(got["sharded.loss"], got["whole.loss"],
                                   rtol=5e-4)
        np.testing.assert_allclose(got["sharded.logits"],
                                   got["whole.logits"], rtol=2e-2, atol=2e-2)


def test_fsdp_region_on_the_card(cuda_device, tmp_path):
    """A ``(2, 1)`` gloo world, both ranks on this card
    (``tests/torch_fsdp_world.py``'s ``card`` case): the data axis's
    gather is bitwise ``torch.cat`` of the ranks' pieces, its backward
    bitwise the f32 sum of the ranks' gradients cut to the rank's piece,
    on CUDA tensors, bf16 and f32."""
    import json
    import os
    import sys
    from repro_torch.scripts import local_world
    here = os.path.dirname(os.path.abspath(__file__))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"mesh": [2, 1], "device": "cuda",
                                "cases": ["card"]}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here]))
    runs = local_world.spawn([sys.executable,
                              os.path.join(here, "torch_fsdp_world.py"),
                              str(spec), str(tmp_path)], 2, timeout=300,
                             env=env, workdir=str(tmp_path))
    for k, run in enumerate(runs):
        assert run.returncode == 0, f"rank {k}:\n{run.stdout}{run.stderr}"
        errors = json.loads((tmp_path / f"rank{k}.json").read_text())
        assert not errors["errors"], errors
        got = dict(np.load(tmp_path / f"card_{k}.npz"))
        assert len(got) == 8 and all(bool(v) for v in got.values()), got


@pytest.mark.parametrize("moment", [torch.bfloat16, torch.float32])
def test_bf16_adamw_sequence_on_the_card_matches_the_cpu(cuda_device,
                                                         moment):
    """The optimizer's bf16 sequence (bf16 parameters and gradients, the
    clip, moments of either dtype) on CUDA tensors equals its CPU run
    bitwise, given the same learning rate and bias corrections."""
    from repro_torch.train import optimizer as opt
    oc = opt.OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=50)
    g = torch.Generator().manual_seed(3)
    leaves = {"layers.0.attn.wq": (64, 4, 16), "final_norm": (64,),
              "embed": (256, 64)}
    host = {name: [torch.randn(s, generator=g).to(dt) for dt in
                   (torch.bfloat16, torch.bfloat16, moment, moment)]
            for name, s in leaves.items()}
    for name in host:
        host[name][3] = host[name][3].abs()
    consts = opt.adam_consts(torch.tensor(3, dtype=torch.int32), oc)
    runs = {}
    for dev in ("cpu", cuda_device):
        ps = {n: [t.to(dev, copy=True) for t in v] for n, v in host.items()}
        grads = {n: v[1] for n, v in ps.items()}
        opt.scale_grads(grads, torch.tensor(40.0, device=dev), 1.0)
        out = {}
        for n, (p, gr, m, v) in ps.items():
            s = torch.empty(p.shape, dtype=torch.float32, device=dev)
            m2, v2 = opt.adamw_leaf(n, p, grads[n], m, v, s, oc,
                                    tuple(c.to(dev) for c in consts))
            out[n] = [p.cpu(), m2.cpu(), v2.cpu()]
        runs[str(dev)] = out
    cpu, card = runs["cpu"], runs[str(cuda_device)]
    for n in leaves:
        assert card[n][0].dtype == torch.bfloat16
        assert card[n][1].dtype == card[n][2].dtype == torch.float32
        for a, b in zip(card[n], cpu[n]):
            assert torch.equal(a, b), n


# ---- the launch tooling, the local step at fsdp=True, the examples ---------------

def test_examples_on_the_card(cuda_device, tmp_path, capsys):
    """Each example twin with ``device="cuda"``: quickstart's CSR against
    the host oracle, serve_lm's 12 requests, three train_lm steps, the
    sharded load in an NCCL world of one."""
    from repro_torch.examples import (distributed_load, quickstart, serve_lm,
                                      train_lm)
    got = quickstart.run("cuda", str(tmp_path))
    edges = np.loadtxt(got["path"], dtype=np.int64) - 1
    offsets, targets, _ = _oracle(edges[:, 0], edges[:, 1], None, got["v"])
    assert np.array_equal(got["csr"].offsets, offsets)
    assert np.array_equal(got["csr"].targets, targets)
    assert serve_lm.main(["--device", "cuda"]) == 0
    assert "served 12 requests / 288 tokens" in capsys.readouterr().out
    hist = train_lm.run(train_lm.parse(["--device", "cuda", "--steps", "3"]))
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    row = distributed_load.rank_main("nccl", "cuda")
    assert row["world"] == 1 and int(row["csr"].offsets[-1]) == 8 << 12


def test_dry_run_of_a_reduced_cell_on_fake_cuda_tensors(cuda_device):
    """The reduced mixtral's GSPMD step at ``fsdp=True`` on fake ``cuda``
    tensors in a fake ``(2, 2)`` world standing for NCCL: its FLOPs and
    collectives counted (NCCL's reduce-scatter where gloo's route takes
    an all-to-all), the fake world gone after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.shapes import ShapeCase
    with fake_world(4, like="nccl"):
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        got = dryrun.measure_cell(reduced_config("mixtral-8x22b"),
                                  ShapeCase("small", 16, 8, "train"), mesh,
                                  device="cuda", fsdp=True, accum=2)
    assert not dist.is_initialized()
    assert got["flops_per_device"] > 0
    calls = got["collective_calls_per_device"]
    assert calls["all-gather"] > 0 and calls["reduce-scatter"] > 0, calls
    assert "all-to-all" not in calls
    assert got["memory"]["argument_gb"] > 0


def test_local_step_at_fsdp_in_an_nccl_world_of_one(cuda_device, tmp_path):
    """The local-accumulation step at ``fsdp=True`` on a ``(1, 1)`` mesh
    (a data group of one: nothing to gather) equals the step at
    ``fsdp=False`` bitwise, two steps."""
    import torch.distributed as dist
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_local_accum_train_step
    cfg = reduced_config("phi4-mini-3.8b")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=0, decay_steps=50)
    batch = synthetic_batch(cfg, 8, 32, 0, device=cuda_device)
    base = init_params(cfg, 0, device=cuda_device, dtype=torch.float32)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/world",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        runs = []
        for fsdp in (True, False):
            model = tpar.shard_model(copy.deepcopy(base), cfg, mesh,
                                     fsdp=fsdp)
            state = init_state(model)
            step = make_local_accum_train_step(cfg, oc, mesh, accum_steps=2)
            losses = []
            for _ in range(2):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            runs.append((losses, state))
        (l1, s1), (l0, s0) = runs
        assert l1 == l0 and all(np.isfinite(l1))
        for a, b in zip(s1.params.parameters(), s0.params.parameters()):
            assert a.is_cuda and torch.equal(a, b)
        for name in s0.mu:
            assert torch.equal(s1.mu[name], s0.mu[name])
            assert torch.equal(s1.nu[name], s0.nu[name])
    finally:
        dist.destroy_process_group()


# ---- the host engines' products on the card -----------------------------------

@pytest.mark.parametrize("engine", ["numpy", "threads"])
@pytest.mark.parametrize("method", ["staged", "binned"])
def test_host_engine_csr_lands_on_the_card(cuda_device, weighted_text, engine,
                                           method):
    """A host engine parses and builds on the host and moves the CSR to the
    card once: the CUDA tensors equal the ``device`` engine's CSR (offsets,
    targets) and the host engine's CPU run (weights too); the card runs no
    kernel for it."""
    knob = {"num_workers": 3} if engine == "threads" else {}
    kernels.reset_launches()
    got = repro_torch.load_csr(weighted_text, engine=engine, weighted=True,
                               method=method, **knob)
    assert sum(kernels.LAUNCHES.values()) == 0
    assert got.offsets.is_cuda and got.targets.is_cuda and got.weights.is_cuda
    assert got.offsets.dtype == torch.int64
    dev = repro_torch.load_csr(weighted_text, weighted=True, method=method)
    assert torch.equal(got.offsets, dev.offsets)
    assert torch.equal(got.targets, dev.targets)
    _same_csr(got, repro_torch.load_csr(weighted_text, engine=engine,
                                        weighted=True, method=method,
                                        device="cpu"))
    el = repro_torch.load_edgelist(weighted_text, engine=engine,
                                   weighted=True)
    assert el.src.is_cuda and el.weights.is_cuda


@pytest.mark.parametrize("method", ["global", "staged", "binned"])
def test_convert_to_csr_numpy_of_a_card_edge_list(cuda_device, weighted_text,
                                                  method):
    from repro_torch.core import convert_to_csr
    el = repro_torch.load_edgelist(weighted_text, weighted=True)
    kernels.reset_launches()
    got = convert_to_csr(el, method=method, engine="numpy")
    assert sum(kernels.LAUNCHES.values()) == 0
    assert got.offsets.is_cuda and got.targets.is_cuda and got.weights.is_cuda
    _same_csr(got, convert_to_csr(el.to("cpu"), method=method))


# ---- the recurrences' chunked scan ------------------------------------------
# the kernel steps each channel's recurrence in order and the plain version
# combines in jax's tree order: f32 rounding in another order, states of a
# few units here, so 1e-5 relative and absolute (the CPU tests' F64_TOL);
# against the same sequential loop in torch ops on the card, bitwise
SCAN_TOL = 1e-5


def _scan_inputs(g, steps, channels, zero_h0):
    a = torch.rand((2, steps, channels), generator=g) * 0.5 + 0.5
    b = torch.randn((2, steps, channels), generator=g)
    h0 = (torch.zeros((2, channels)) if zero_h0 else
          torch.randn((2, channels), generator=g))
    return a, b, h0


@pytest.mark.parametrize("reverse", [False, True])
def test_linear_scan_kernel_matches_plain_and_the_loop(cuda_device, reverse):
    """T in {1, 7, 256, 300}; 2 x C threads below one block of 256 and
    across several; a zero and a random h0: one launch a call."""
    g = torch.Generator().manual_seed(0)
    for steps in (1, 7, 256, 300):
        for channels in (5, 100, 1000):
            for zero_h0 in (True, False):
                a, b, h0 = _scan_inputs(g, steps, channels, zero_h0)
                on = [t.to(cuda_device) for t in (a, b, h0)]
                kernels.reset_launches()
                got = kernels.linear_scan(*on, reverse=reverse)
                assert kernels.LAUNCHES["linear_scan"] == 1
                want = kernels.linear_scan_ref(a, b, h0, reverse)
                torch.testing.assert_close(got.cpu(), want, rtol=SCAN_TOL,
                                           atol=SCAN_TOL)
                loop = kernels.linear_scan_loop(*on, reverse=reverse)
                assert torch.equal(got, loop), (steps, channels, zero_h0)


@pytest.mark.parametrize("reverse", [False, True])
def test_linear_scan_gradients_on_the_card(cuda_device, reverse):
    """The op's backward (the kernel reversed, one more launch) against
    autograd through the plain version on the CPU."""
    g = torch.Generator().manual_seed(1)
    a, b, h0 = _scan_inputs(g, 300, 130, False)
    gh = torch.randn(a.shape, generator=g)
    grads = []
    for dev, fn in ((cuda_device, kernels.linear_scan),
                    ("cpu", kernels.linear_scan_ref)):
        xs = [t.to(dev).requires_grad_() for t in (a, b, h0)]
        kernels.reset_launches()
        (fn(*xs, reverse=reverse) * gh.to(dev)).sum().backward()
        grads.append([x.grad.cpu() for x in xs])
        if dev != "cpu":
            assert kernels.LAUNCHES["linear_scan"] == 2
    for got, want in zip(*grads):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= SCAN_TOL * scale


def test_linear_scan_refuses_what_the_kernel_cannot_run(cuda_device):
    a = torch.rand((1, 4, 3), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        kernels.linear_scan(a, a, torch.zeros((1, 3), dtype=torch.float64,
                                              device=cuda_device))
    kernels.reset_launches()
    empty = torch.empty((2, 0, 3), device=cuda_device)
    assert kernels.linear_scan(empty, empty).shape == (2, 0, 3)
    assert kernels.LAUNCHES["linear_scan"] == 0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_recurrent_prefill_on_the_card_launches_the_scan(cuda_device, arch):
    """The reduced arch's prefill over 512 tokens (2 chunks): 2 launches a
    recurrent layer; the logits and every cache leaf against the CPU run
    of the same weights within ``COMPILED_TOL``, as the serving kinds'."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import forward_prefill, init_params
    from repro_torch.models.blocks import layer_kinds
    cfg = reduced_config(arch)
    cpu = init_params(cfg, 3, device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    want = forward_prefill(cpu, {"tokens": toks}, cfg, 512)
    kernels.reset_launches()
    got = forward_prefill(card, {"tokens": toks.to(cuda_device)}, cfg, 512)
    layers = sum(k in ("mamba", "rglru") for k in layer_kinds(cfg))
    assert kernels.LAUNCHES["linear_scan"] == 2 * layers
    tol = torch_lm.COMPILED_TOL
    np.testing.assert_allclose(got[0].float().cpu().numpy(),
                               want[0].float().numpy(), rtol=tol, atol=tol)
    for c, wc in zip(got[1], want[1]):
        for k in c:
            np.testing.assert_allclose(c[k].float().cpu().numpy(),
                                       wc[k].float().numpy(), rtol=tol,
                                       atol=tol, err_msg=k)
