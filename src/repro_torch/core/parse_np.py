"""Single-pass vectorized edgelist parsing in numpy: the host engines' parse.

The port's own copy of ``repro/core/parse_np.py``, the same code: the mask
and scan algebra of the card's parse (:mod:`.parse`) in numpy's C kernels,
with uint8 table lookups for the byte classes, int32 cumsums, shifted-slice
token boundaries, power-of-ten tables and prefix-sum line ids.  It is
GVEL's single-pass custom parser on the CPU, run by the ``numpy`` and
``threads`` engines (:mod:`.edgelist`) and by the paper's baselines
(:mod:`.baselines`).  It takes and returns numpy arrays.

Chunks handed to this parser must be split at newline boundaries
(:func:`chunk_bounds` backs each cut off to the previous newline, the
literal getBlock analogue).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_POW10 = 10 ** np.arange(19, dtype=np.int64)
_POW10F = 10.0 ** np.arange(19)

# one-gather byte classification (replaces ~13 compare/or passes with 4
# table lookups — the vector analogue of GVEL's custom parser dispatch)
_IS_DIGIT = np.zeros(256, bool)
_IS_DIGIT[48:58] = True
_IS_TOK = _IS_DIGIT.copy()
_IS_TOK[[45, 46]] = True
_IS_NL = np.zeros(256, bool)
_IS_NL[10] = True
_IS_BAD = ~_IS_TOK
_IS_BAD[[10, 32, 9, 13]] = False


def parse_chunk_np(
    data: np.ndarray,
    *,
    weighted: bool,
    base: int = 1,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], int]:
    """Parse a newline-terminated chunk -> (src, dst, w, count).  int64 ids."""
    d = np.asarray(data)
    n = d.shape[0]
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros(0, np.float64) if weighted else None, 0)
    if n == 0:
        return empty

    # ---- byte classes: one table gather per class ----------------------------
    is_digit = _IS_DIGIT[d]
    is_nl = _IS_NL[d]
    is_tok = _IS_TOK[d]

    # ---- token boundaries: single xor pass + small gathers --------------------
    flips = np.flatnonzero(is_tok[1:] != is_tok[:-1]) + 1
    if is_tok[0]:
        flips = np.concatenate(([0], flips))
    if is_tok[-1]:
        flips = np.concatenate((flips, [n]))
    tok_starts = flips[0::2]
    tok_ends = flips[1::2] - 1
    T = tok_starts.size
    if T == 0:
        return empty
    tok_len = tok_ends - tok_starts + 1

    # ---- integer values: digit * 10^(digits after it in the token) ----------
    cum_dig = np.cumsum(is_digit, dtype=np.int32)   # chunk < 2^31 bytes
    tok_bytes = np.flatnonzero(is_tok)
    end_per_elem = np.repeat(tok_ends, tok_len)
    digits_after = (cum_dig[end_per_elem] - cum_dig[tok_bytes]).astype(np.int64)
    dv = d[tok_bytes].astype(np.int64) - 48
    dmask = is_digit[tok_bytes]
    contrib = np.where(dmask, dv, 0) * _POW10[np.minimum(digits_after, 18)]
    tok_offsets = np.zeros(T, np.int64)
    np.cumsum(tok_len[:-1], out=tok_offsets[1:])
    tok_int = np.add.reduceat(contrib, tok_offsets)

    if weighted:
        frac_len = np.zeros(T, np.int64)
        dot_bytes = np.flatnonzero(is_tok & (d == 46))
        if dot_bytes.size:
            tok_of_dot = np.searchsorted(tok_starts, dot_bytes,
                                         side="right") - 1
            frac_len[tok_of_dot] = cum_dig[tok_ends[tok_of_dot]] \
                - cum_dig[dot_bytes]
        neg = np.zeros(T, bool)
        minus_bytes = np.flatnonzero(is_tok & (d == 45))
        if minus_bytes.size:
            neg[np.searchsorted(tok_starts, minus_bytes, side="right") - 1] = True
        tok_float = tok_int / _POW10F[np.minimum(frac_len, 18)]
        tok_float = np.where(neg, -tok_float, tok_float)

    # ---- line assembly (prefix-sum line ids; tokens are line-sorted) --------
    cum_nl = np.cumsum(is_nl, dtype=np.int32)
    num_lines = int(cum_nl[-1]) + (0 if is_nl[-1] else 1)
    tok_line = cum_nl[tok_starts]            # newlines before start
    ntok = np.bincount(tok_line, minlength=num_lines)
    first_tok = np.zeros(num_lines, np.int64)
    np.cumsum(ntok[:-1], out=first_tok[1:])
    ord_in_line = np.arange(T) - first_tok[tok_line]

    valid = ntok >= 2
    # bad-byte rejection (comments, junk): rare — scan only when present
    bad_bytes = np.flatnonzero(_IS_BAD[d])
    if bad_bytes.size:
        valid[cum_nl[bad_bytes]] = False

    src_l = np.full(num_lines, -1, np.int64)
    dst_l = np.full(num_lines, -1, np.int64)
    sel0 = ord_in_line == 0
    sel1 = ord_in_line == 1
    src_l[tok_line[sel0]] = tok_int[sel0]
    dst_l[tok_line[sel1]] = tok_int[sel1]
    if weighted:
        w_l = np.ones(num_lines, np.float64)
        sel2 = ord_in_line == 2
        w_l[tok_line[sel2]] = tok_float[sel2]

    src = src_l[valid] - base
    dst = dst_l[valid] - base
    w = w_l[valid] if weighted else None
    return src, dst, w, int(valid.sum())


def chunk_bounds(data: np.ndarray, num_chunks: int) -> list[tuple[int, int]]:
    """Split a byte buffer into ~equal chunks at newline boundaries
    (host-literal getBlock: back off each cut to the previous newline)."""
    n = len(data)
    raw = np.linspace(0, n, num_chunks + 1).astype(np.int64)
    cuts = [0]
    view = data.tobytes() if not isinstance(data, (bytes, bytearray)) else data
    for c in raw[1:-1]:
        p = view.rfind(b"\n", 0, int(c))
        cuts.append(p + 1 if p >= 0 else 0)
    cuts.append(n)
    cuts = sorted(set(cuts))
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]
