"""Inputs built against the tile design of the port's parse and scan kernels.

Plain numpy from a seed, no jax: ``tests/test_torch_parse_tiles.py`` feeds
them to the JAX package and to the port's plain versions on the CPU, and
``tests/test_torch_cuda.py`` feeds the same inputs to the kernels on the
card.  pytest does not collect this module (its name has no ``test_``).

The geometry mirrors ``src/repro_torch/csrc``: ``parse_edges.cu`` cuts each
row's region into tiles of ``PARSE_TILE`` bytes and reads a ``PARSE_HALO``
of bytes before each tile; ``exclusive_scan.cu`` scans tiles of
``SCAN_TILE`` int32.
"""
import numpy as np

PARSE_TILE = 3840
PARSE_HALO = 256
SCAN_TILE = 4096

# one row shape for every parse case: a beta of 16 KiB plus the loader's
# 64-byte overlap, so the rows cover several parse tiles and two multiples
# of 8,192 bytes
OVERLAP = 64
BETA = 16384
ROW_LEN = BETA + OVERLAP
OWNED = (OVERLAP, OVERLAP + BETA)

# lines the parse must get right wherever they fall
HAZARDS = (
    b"12345678901 2",          # token value wraps in int32
    b"1 2 123456789.123",      # weight mantissa wraps
    b"3 4 1.2.5",              # fraction after the LAST dot
    b"1 2 7-2",                # a minus anywhere negates
    b"1 2 -",                  # lone minus -> -0.0
    b"5 6",                    # missing weight -> 1.0
    b"# c 1 2",                # bad byte: dropped
    b"1 2 3 4",                # tokens past the third ignored
    b"7 8\r",                  # CRLF
    b"\t9\t10  2.50 ",         # tabs and blanks
    b"abc", b"1 x 2", b"", b".", b"-",   # garbage, blank, one-token lines
)


def _line(rng, weighted: bool) -> bytes:
    """One random line: mostly edges, sometimes a hazard."""
    if rng.random() < 0.15:
        return HAZARDS[int(rng.integers(0, len(HAZARDS)))]
    u, v = rng.integers(0, 10 ** int(rng.integers(1, 10)), 2)
    sep = b"\t" if rng.random() < 0.1 else b" "
    text = str(u).encode() + sep + str(v).encode()
    if weighted:
        w = rng.normal() * 10.0 ** int(rng.integers(0, 4))
        text += b" " + f"{w:.{int(rng.integers(0, 6))}f}".encode()
    if rng.random() < 0.1:
        text += b"\r"
    return text


def _filler(rng, n: int, weighted: bool) -> bytes:
    """Exactly ``n`` bytes of whole lines (a remainder under 4 bytes is
    blanks that lead the next line)."""
    out = bytearray()
    while n - len(out) >= 8:
        line = _line(rng, weighted)[: n - len(out) - 1] + b"\n"
        out += line
    rest = n - len(out)
    if rest >= 4:
        out += b"1 2" + b" " * (rest - 4) + b"\n"
    else:
        out += b" " * rest
    return bytes(out)


def tile_boundaries(row_len: int = ROW_LEN, owned_start: int = OVERLAP):
    """Row offsets where a tile or its halo starts, for both entry points
    (``parse_bytes`` tiles the whole row, ``parse_accumulate`` the owned
    range), and every multiple of 256 bytes (so of 512, 1,024, 4,096 and
    8,192 too)."""
    marks = set(range(256, row_len, 256))
    for origin in (0, owned_start):
        for lo in range(origin + PARSE_TILE, row_len, PARSE_TILE):
            marks.update((lo, lo - PARSE_HALO))
    return sorted(marks)


def _place(rng, weighted: bool, row_len: int, special) -> np.ndarray:
    """A row of random lines with ``special(mark)`` -> ``(line, at)`` put so
    that byte ``at`` of ``line`` lands on each mark of
    :func:`tile_boundaries`.  Special lines are at most 30 bytes and the
    marks at least 64 apart, so every mark gets its line."""
    out = bytearray()
    for mark in tile_boundaries(row_len):
        line, at = special(mark)
        gap = mark - at - len(out)
        assert gap >= 0
        out += _filler(rng, gap, weighted) + line
    out += _filler(rng, row_len - len(out), weighted)
    return np.frombuffer(bytes(out[:row_len]), np.uint8).copy()


def _short_line(rng, weighted: bool) -> bytes:
    line = _line(rng, weighted).rstrip(b"\r")[:24]
    return line if len(line) >= 2 else b"3 4"


def straddle_row(rng, weighted: bool, row_len: int = ROW_LEN) -> np.ndarray:
    """A row in which a line runs across every mark of
    :func:`tile_boundaries`: the mark falls on a random byte of it that is
    neither its newline nor its first byte."""
    def special(_mark):
        line = _short_line(rng, weighted) + b"\n"
        return line, int(rng.integers(1, len(line) - 1))
    return _place(rng, weighted, row_len, special)


EDGE_KINDS = ("crlf_split", "cr_first", "nl_first", "nl_before")


def edge_row(rng, weighted: bool, row_len: int = ROW_LEN) -> np.ndarray:
    """A row whose marks take turns at a CRLF split across the mark
    (``\\r`` before it, ``\\n`` on it), a CR on the mark, a newline on the
    mark, and a newline just before it."""
    kinds = iter(range(10**6))

    def special(_mark):
        line = _short_line(rng, weighted)
        kind = EDGE_KINDS[next(kinds) % len(EDGE_KINDS)]
        if kind == "crlf_split":
            return line + b"\r\n", len(line) + 1
        if kind == "cr_first":
            return line + b"\r\n", len(line)
        if kind == "nl_first":
            return line + b"\n", len(line)
        return line + b"\n", len(line) + 1
    return _place(rng, weighted, row_len, special)


def long_line_row(rng, weighted: bool, row_len: int = ROW_LEN) -> np.ndarray:
    """A row whose lines are longer than the halo: one starts 2.5 tiles
    before its newline (whole tiles hold no newline), one is 300 bytes, and
    one ends on the last owned byte."""
    long1 = b"17" + b" " * int(2.5 * PARSE_TILE) + b"42 3.25\n"
    long2 = b"5" + b"\t" * 290 + b"6 -0.5\n"
    head = _filler(rng, 700, weighted) + long1 + _filler(rng, 333, weighted)
    body = head + long2
    tail_len = row_len - len(body)
    tail = _filler(rng, tail_len - 400, weighted) + b"8" + b" " * 397 + b"9\n"
    row = body + tail
    assert len(row) == row_len and row[-1:] == b"\n"
    return np.frombuffer(row, np.uint8).copy()


def no_newline_row(row_len: int = ROW_LEN) -> np.ndarray:
    """A row of edge-like text without one newline."""
    text = (b"123 456 7.5 " * (row_len // 12 + 1))[:row_len]
    return np.frombuffer(text, np.uint8).copy()


def owned_edge_row(rng, weighted: bool, owned=OWNED,
                   row_len: int = ROW_LEN) -> np.ndarray:
    """Newlines on the first owned byte and on the last owned byte, each
    ending an edge line."""
    lo, hi = owned
    first = b"21 22\n"
    head = _filler(rng, lo - len(first) + 1, weighted) + first
    last = b"31 32 0.125\n"
    mid = _filler(rng, hi - len(head) - len(last), weighted)
    row = head + mid + last + _filler(rng, row_len - hi, weighted)
    assert row[lo] == 10 and row[hi - 1] == 10 and len(row) == row_len
    return np.frombuffer(row, np.uint8).copy()


def tile_rows(seed: int, weighted: bool) -> np.ndarray:
    """``(6, ROW_LEN)`` uint8: a straddle row, an edge row, the long-line
    row, the no-newline row, the owned-edge row and one more straddle
    row."""
    rng = np.random.default_rng(seed)
    return np.stack([straddle_row(rng, weighted), edge_row(rng, weighted),
                     long_line_row(rng, weighted), no_newline_row(),
                     owned_edge_row(rng, weighted),
                     straddle_row(rng, weighted)])


def flat_span(rows: np.ndarray, beta: int = BETA) -> np.ndarray:
    """The loader's flat span for rows that alias: row b is bytes
    ``[b * beta, b * beta + ROW_LEN)``.  Each row keeps its own bytes and
    lends its last ``ROW_LEN - beta`` to the next row's unowned prefix, so
    parse the strided view of the span, not ``rows``."""
    nb, n = rows.shape
    span = np.full((nb - 1) * beta + n, 10, np.uint8)
    for b in reversed(range(nb)):
        span[b * beta: b * beta + n] = rows[b]
    return span


# scan lengths around the kernel's tile
SCAN_SIZES = (1, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1, 3 * SCAN_TILE + 7)


def scan_input(n: int, seed: int, wrap: bool = False) -> np.ndarray:
    """int32 degrees; with ``wrap`` their sum passes 2**32 several times."""
    rng = np.random.default_rng(seed)
    hi = 2**30 if wrap else 1000
    return rng.integers(0, hi, n).astype(np.int32)


def garbage_accumulators(cap: int, seed: int, weighted: bool):
    """Accumulators that hold garbage everywhere (not the fresh -1 / -1 /
    0.0), to pin that a batch writes its whole window and nothing else."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-2**31, 2**31, cap).astype(np.int32)
    dst = rng.integers(-2**31, 2**31, cap).astype(np.int32)
    w = rng.normal(size=cap).astype(np.float32) if weighted else None
    return src, dst, w


# ---------------------------------------------------------------------------
# degree_histogram: ``degree_histogram.cu`` gives each thread 16 consecutive
# ids of a 4,096-id tile (``HIST_TILE``), a warp 512 (``HIST_WARP``), and
# aligns the tiles to 16-byte boundaries of the address space
# ---------------------------------------------------------------------------

HIST_CHUNK, HIST_WARP, HIST_TILE = 16, 512, 4096
HIST_SIZES = (1, 15, 16, 17, 4095, 4096, 4097)


def sorted_runs(e: int, v: int, seed: int) -> np.ndarray:
    """Sorted int32 ids in ``[0, v)`` whose runs cross every thread-chunk,
    warp and tile boundary: no run starts on a multiple of 16, and some
    runs are longer than a warp's 512 ids and a tile's 4,096."""
    rng = np.random.default_rng(seed)
    lengths, total = [], 0
    while total < e:
        kind = rng.random()
        if kind < 0.05:
            n = int(rng.integers(HIST_TILE, 2 * HIST_TILE))
        elif kind < 0.15:
            n = int(rng.integers(HIST_WARP, 2 * HIST_WARP))
        else:
            n = int(rng.integers(1, 40))
        if (total + n) % HIST_CHUNK == 0:
            n += 1                      # the next run starts inside a chunk
        lengths.append(n)
        total += n
    ids = np.sort(rng.choice(v, size=len(lengths), replace=len(lengths) > v))
    return np.repeat(ids, lengths)[:e].astype(np.int32)


def padded_partitions(rho: int, p: int, v: int, seed: int) -> np.ndarray:
    """``(rho, p)`` int32 rows as the staged build sorts them: each row
    sorted, holding runs of -1 and of ids >= V among the valid ids, and
    ending in a run of the padding key V."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(rho):
        pad = int(rng.integers(1, max(p // 3, 2)))
        body = rng.integers(-1, v + 3, p - pad)
        body[rng.random(p - pad) < 0.1] = -1
        rows.append(np.concatenate([np.sort(body), np.full(pad, v)]))
    return np.stack(rows).astype(np.int32)


def stream_ids(e: int, v: int, seed: int) -> np.ndarray:
    """Ids in stream order: padding, in-range ids and ids >= V."""
    return np.random.default_rng(seed).integers(-1, v + 3, e).astype(np.int32)


# ---------------------------------------------------------------------------
# neighbor_gather: ``neighbor_gather.cu`` gives each warp a group of 32
# consecutive ids (``GATHER_GROUP``) and stores int4 rows when the width is a
# multiple of 4
# ---------------------------------------------------------------------------

GATHER_GROUP = 32
GATHER_WIDTHS = (5, 33, 128, 1000)
GATHER_BATCHES = (1, 31, 33)
I32_MIN, I32_MAX = -2**31, 2**31 - 1


def gather_csr(v: int, e: int, width: int, seed: int):
    """CSR ``(offsets int64, targets int32)`` of about ``e`` edges with
    degree-0 rows, rows that start at every ``lo % 4`` and one hot vertex
    (``v // 2``) of degree far above ``width``."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 2 * width, v)
    deg = deg * e // max(int(deg.sum()), 1) + (np.arange(v) % 4 == 1)
    deg[rng.random(v) < 0.2] = 0
    deg[v // 2] = 6 * width + 3                          # the hot vertex
    off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    assert {int(x) % 4 for x in off[:-1]} == {0, 1, 2, 3}
    return off, rng.integers(0, v, int(off[-1])).astype(np.int32)


def gather_ids(v: int, b: int, seed: int) -> np.ndarray:
    """``b`` int32 ids: in-range ids (the hot vertex among them), every
    neighbour of ``[0, v]``, wrapped negatives and the int32 extremes, mixed
    so a group of 32 holds several kinds."""
    rng = np.random.default_rng(seed)
    special = np.concatenate([np.arange(-v - 3, v + 4),
                              [I32_MIN, I32_MIN + 1, -1, I32_MAX - 1,
                               I32_MAX, v // 2, v // 2]])
    ids = rng.integers(0, v, b)
    k = min(b, len(special))
    ids[rng.choice(b, k, replace=False)] = rng.choice(special, k,
                                                      replace=False)
    return ids.astype(np.int32)


# ---------------------------------------------------------------------------
# graph files for the snapshot, framed and MTX paths
# ---------------------------------------------------------------------------

def graph_edges(seed: int, v: int = 60, e: int = 401, weighted: bool = False,
                isolated: int = 3, loops: int = 0):
    """Random multigraph edges (0-based int32); the last ``isolated``
    vertices have no edges, ``loops`` edges are made self-loops, weights
    have 3 decimals (they print and parse exactly as float32)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v - isolated, e).astype(np.int32)
    dst = rng.integers(0, v - isolated, e).astype(np.int32)
    if loops:
        at = rng.choice(e, loops, replace=False)
        dst[at] = src[at]
    w = None
    if weighted:
        w = np.array([np.float32(f"{x:.3f}")
                      for x in rng.random(e) * 90 + 0.001], np.float32)
    return src, dst, w


def write_text(path, src, dst, w=None, base: int = 1) -> None:
    """``u v[ w]`` lines; weights printed with 3 decimals."""
    with open(path, "w") as f:
        for i in range(len(src)):
            line = f"{int(src[i]) + base} {int(dst[i]) + base}"
            if w is not None:
                line += f" {float(w[i]):.3f}"
            f.write(line + "\n")


def mtx_expand(src, dst, w):
    """A symmetric MTX file's edges: the stored entries, then the reverse
    of each entry that is not a self-loop, in entry order."""
    keep = src != dst
    return (np.concatenate([src, dst[keep]]), np.concatenate([dst, src[keep]]),
            None if w is None else np.concatenate([w, w[keep]]))


# ---------------------------------------------------------------------------
# the staged build's edge shapes
# ---------------------------------------------------------------------------

STAGED_CASES = ("uneven", "tiny", "empty_partition", "padding", "above_v",
                "v1", "hub")


def staged_edges(case: str, seed: int):
    """``(src, dst, w, V)`` (int32, int32, float32) for one shape the staged
    build must cut and place: 4,001 edges (``e % rho != 0`` for rho 4 and
    7), 3 (fewer than rho: empty partitions), a quarter of them padding in
    one block (an empty partition at rho = 4), -1 padding sprinkled and at
    the tail, ids at or above V among them, V = 1, or one hub holding half
    the edges."""
    rng = np.random.default_rng(seed)
    v, e = 300, 4001
    src = rng.integers(0, v, e)
    if case == "tiny":
        e, src = 3, src[:3]
    elif case == "empty_partition":
        src[e // 4:e // 2] = -1
    elif case == "padding":
        src[rng.random(e) < 0.3] = -1
        src[-57:] = -1
    elif case == "above_v":
        above = rng.random(e) < 0.2
        src[above] = rng.integers(v, 3 * v, int(above.sum()))
        src[rng.random(e) < 0.1] = -1
    elif case == "v1":
        v = 1
        src = np.where(rng.random(e) < 0.1, -1, 0)
    elif case == "hub":
        src[rng.random(e) < 0.5] = 7
    elif case != "uneven":
        raise ValueError(case)
    src = src.astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[src < 0] = -1
    return src, dst, rng.normal(size=e).astype(np.float32), v


def _digits(x: np.ndarray, width: int):
    """Right-aligned decimal digits of non-negative ints, and a mask of the
    significant ones."""
    out = np.empty((len(x), width), np.uint8)
    y = x.astype(np.int64)
    for k in range(width - 1, -1, -1):
        out[:, k] = 48 + y % 10
        y //= 10
    nd = 1 + sum((x >= 10 ** k).astype(np.int64) for k in range(1, width))
    return out, np.arange(width)[None, :] >= (width - nd)[:, None]


def write_text_fast(path, src, dst) -> None:
    """1-based ``u v`` lines of large edge arrays, built in numpy."""
    width = len(str(int(max(src.max(), dst.max())) + 1))
    n = len(src)
    sep = (np.full((n, 1), 32, np.uint8), np.ones((n, 1), bool))
    end = (np.full((n, 1), 10, np.uint8), np.ones((n, 1), bool))
    parts = [_digits(src + 1, width), sep, _digits(dst + 1, width), end]
    mat = np.concatenate([p[0] for p in parts], axis=1)
    keep = np.concatenate([p[1] for p in parts], axis=1)
    with open(path, "wb") as f:
        f.write(mat[keep].tobytes())
