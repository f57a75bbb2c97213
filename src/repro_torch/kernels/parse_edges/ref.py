"""Plain PyTorch versions of the ``parse_bytes`` and ``parse_accumulate``
kernels.

The byte algebra of ``repro/core/parse.py::_parse_block_bytes``, operation
for operation, vectorised over the last dimension (so one call covers a
whole ``(nb, buf_len)`` batch where the reference vmaps).  Token values
are exact int64 sums wrapped to int32 at the end, which equals the
reference's wrapping int32 arithmetic modulo 2**32.
"""
from __future__ import annotations

import torch

MAX_DIGITS = 9
I32 = torch.int32

# exact float32 powers of ten, 1 .. 1e9
POW10_F32 = (1.0, 10.0, 100.0, 1000.0, 10000.0, 100000.0, 1000000.0,
             10000000.0, 100000000.0, 1000000000.0)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(I32)


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """``x[..., i-1]`` at ``i`` (``fill`` at 0)."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], -1)


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """``x[..., i+1]`` at ``i`` (``fill`` at the end)."""
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], -1)


def parse_bytes_ref(bufs: torch.Tensor, owned_start: int, owned_end: int, *,
                    weighted: bool, base: int):
    """Per-byte parse of ``(..., n)`` uint8 blocks: ``(valid, src, dst,
    w)``, each shaped like ``bufs`` (``w`` is None when unweighted).

    ``valid`` marks owned newlines (``owned_start <= i < owned_end``)
    that end a line with >= 2 tokens and no bad byte; ``src``/``dst``/``w``
    hold that line's values at those bytes.
    """
    n = bufs.shape[-1]
    dev = bufs.device
    d = bufs.to(torch.int64)
    idx = torch.arange(n, device=dev).expand_as(d)

    def at(x, pos):
        return torch.gather(x, -1, pos)

    def cummax(x):
        return torch.cummax(x, -1).values

    is_digit = (d >= 48) & (d <= 57)
    is_dot = d == 46
    is_minus = d == 45
    is_tok = is_digit | is_dot | is_minus
    is_nl = d == 10
    is_ws = (d == 32) | (d == 9) | (d == 13)
    is_bad = ~(is_tok | is_nl | is_ws)

    tok_start = is_tok & ~_shift_right(is_tok, False)
    tok_end = is_tok & ~_shift_left(is_tok, False)
    cum_ts = torch.cumsum(tok_start, -1)
    cum_dig = torch.cumsum(is_digit, -1)

    # my token's end/start byte position (valid at token bytes)
    end_pos = torch.cummin(torch.where(tok_end, idx, n - 1).flip(-1),
                           -1).values.flip(-1)
    start_pos = cummax(torch.where(tok_start, idx, 0))

    # digits strictly after byte i within its token
    digits_after = (at(cum_dig, end_pos) - cum_dig).clamp(0, MAX_DIGITS)
    pow10 = 10 ** torch.arange(MAX_DIGITS + 1, device=dev)
    contrib = torch.where(is_digit, (d - 48) * pow10[digits_after], 0)
    csum_c = torch.cumsum(contrib, -1)
    excl_c = csum_c - contrib
    # integer value of the token ending at byte i (valid at token ends)
    tok_val = wrap32(csum_c - at(excl_c, start_pos)).to(torch.int64)

    # latest newline strictly before byte i (-1: none)
    pex = _shift_right(cummax(torch.where(is_nl, idx, -1)), -1)
    cts_at = torch.where(pex < 0, 0, at(cum_ts, pex.clamp(min=0)))
    ord_in_line = cum_ts - 1 - cts_at

    def role_pos(k):
        return cummax(torch.where(tok_end & (ord_in_line == k), idx, -1))

    p0, p1 = role_pos(0), role_pos(1)
    bad_pos = cummax(torch.where(is_bad, idx, -1))
    owned = (idx >= owned_start) & (idx < owned_end)
    valid = is_nl & owned & (p1 > pex) & ~(bad_pos > pex)

    src = wrap32(at(tok_val, p0.clamp(min=0)) - base)
    dst = wrap32(at(tok_val, p1.clamp(min=0)) - base)

    w = None
    if weighted:
        p2 = role_pos(2)
        dot_pos = cummax(torch.where(is_dot, idx, -1))
        minus_pos = cummax(torch.where(is_minus, idx, -1))
        p2c = p2.clamp(min=0)
        w_start = at(start_pos, p2c)
        dot_of = at(dot_pos, p2c)
        frac_len = torch.where(
            dot_of >= w_start,
            at(cum_dig, p2c) - at(cum_dig, dot_of.clamp(min=0)), 0)
        pow10_f = torch.tensor(POW10_F32, dtype=torch.float32, device=dev)
        wf = (at(tok_val, p2c).to(I32).to(torch.float32)
              / pow10_f[frac_len.clamp(0, MAX_DIGITS)])
        wf = torch.where(at(minus_pos, p2c) >= w_start, -wf, wf)
        w = torch.where(p2 > pex, wf, torch.ones_like(wf))
    return valid, src, dst, w


def compact_accumulate_ref(acc_src, acc_dst, acc_w, total, valid, src, dst,
                           w, *, edge_bound: int):
    """Pack a batch of per-byte parses into the accumulators at ``total``:
    the reference's ``repro/core/parse.py::_compact_accumulate``.

    ``valid``/``src``/``dst``/``w`` are ``(nb, blen)`` byte-domain parses.
    Blocks pack consecutively and edges within a block stay in line order.
    A window of ``edge_bound`` slots is written at ``total`` (invalid slots
    carry the padding values); the caller guarantees ``total + edge_bound
    <= capacity``.  Returns the accumulators (updated in place) and the new
    ``total``.
    """
    dev = valid.device
    valid_f = valid.reshape(-1)
    flat_n = valid_f.shape[0]
    dest = torch.cumsum(valid_f, 0, dtype=I32) - 1
    count = (dest[-1] + 1).clamp(min=0)
    # one scatter packs byte positions (slot edge_bound is the drop bin)
    slot = torch.where(valid_f & (dest < edge_bound), dest, edge_bound)
    pos = torch.full((edge_bound + 1,), flat_n, dtype=I32, device=dev)
    pos.index_put_((slot.long(),), torch.arange(flat_n, dtype=I32,
                                                device=dev))
    pos = pos[:edge_bound]
    pv = pos < flat_n
    posc = pos.clamp(max=flat_n - 1).long()
    window = total.long() + torch.arange(edge_bound, device=dev)
    acc_src[window] = torch.where(pv, src.reshape(-1)[posc], -1)
    acc_dst[window] = torch.where(pv, dst.reshape(-1)[posc], -1)
    if acc_w is not None and w is not None:
        acc_w[window] = torch.where(pv, w.reshape(-1)[posc], 0.0)
    return acc_src, acc_dst, acc_w, total + count


def parse_accumulate_ref(acc_src, acc_dst, acc_w, total, bufs,
                         owned_start: int, owned_end: int, *, weighted: bool,
                         base: int, edge_bound: int):
    """Plain version of the fused ``parse_accumulate`` kernel: the per-byte
    parse, then :func:`compact_accumulate_ref`."""
    valid, src, dst, w = parse_bytes_ref(bufs, owned_start, owned_end,
                                         weighted=weighted, base=base)
    return compact_accumulate_ref(acc_src, acc_dst, acc_w, total, valid, src,
                                  dst, w, edge_bound=edge_bound)
