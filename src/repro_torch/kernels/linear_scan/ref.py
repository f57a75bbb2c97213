"""Plain PyTorch version of the ``linear_scan`` kernel: the reference's
chunked associative scan.

The reference scans each chunk of a recurrent layer with
``jax.lax.associative_scan`` over the combine ``(a1 * a2, b1 * a2 + b2)``
and then reads ``h = cA * h0 + cB`` (``repro/models/mamba.py:54-65``,
``repro/models/rglru.py:67-76``).  :func:`associative_scan` runs the same
odd/even recursion as jax's (``_scan`` in ``jax/_src/lax/control_flow/
loops.py``): combine adjacent pairs, scan the half-length result, combine
its elements with the even-indexed inputs, interleave.  Its depth is
``log2(T)``; no Python loop runs over tokens.  Every element goes through
the same float ops in the same order as jax's, so on the CPU the results
equal the reference's run op by op.
"""
from __future__ import annotations

import torch


def _combine(a1, b1, a2, b2):
    return a1 * a2, b1 * a2 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even[0], odd[0], even[1], odd[1], ...`` along dim 1 (``even`` as
    long as ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], 1)


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """``(cA, cB)`` of ``(B, T, ...)`` ``a`` and ``b``: the inclusive scan
    of the pairs ``(a_t, b_t)`` along dim 1 under the combine above, in
    jax's order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def linear_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """``h`` of ``(B, T, C)`` ``a`` and ``b`` from ``h0`` ``(B, C)``:
    ``h_t = a_t * h_{t-1} + b_t`` with ``h_{-1} = h0``, or, ``reverse``,
    ``h_t = a_t * h_{t+1} + b_t`` with ``h_T = h0`` (the time axis
    flipped, as jax's ``reverse=True``)."""
    if reverse:
        a, b = a.flip(1), b.flip(1)
    ca, cb = associative_scan(a, b)
    h = ca * h0[:, None] + cb
    return h.flip(1) if reverse else h


def linear_scan_loop(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                     reverse: bool = False) -> torch.Tensor:
    """The same recurrence stepped token by token, ``h = a_t * h + b_t``:
    the order the kernel runs, so on the card the kernel equals it
    bitwise.  For tests and checks only."""
    steps = range(a.shape[1] - 1, -1, -1) if reverse else range(a.shape[1])
    h, out = h0, [None] * a.shape[1]
    for t in steps:
        h = a[:, t] * h + b[:, t]
        out[t] = h
    return torch.stack(out, dim=1) if out else torch.empty_like(b)
