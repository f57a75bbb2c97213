"""Random walks over a CSR -> LM token sequences; the port of
``repro/data/walks.py``.

Each walk step is two reads of ``offsets`` and one uniformly drawn read of
``targets``; a dead end (out-degree 0) self-loops, and on an edgeless graph
every vertex does.  Vertex ids map to tokens modulo the model vocab.

Determinism is the reference's, bit for bit (``data/prng.py`` is the
threefry of ``jax.random``): walk ``i`` derives its stream from
``fold_in(key, walk_offset + i)``, so the same key gives the same walks
across calls and across batch splits; the start is drawn under
``fold_in(k, _START_TAG)`` and step ``s`` under ``fold_in(k, s)``.

The reference scans the steps with ``lax.scan``.  Here the draws depend
only on the keys and the step index, not on where a walk stands, so all
steps' random words are drawn in one vectorised pass; the loop over steps
is then a handful of gathers each.  Plain tensor code: the reference has
no Pallas kernel on this path.
"""
from __future__ import annotations

import torch

from ..core.indexing import row_bounds, wrap_int32
from . import prng

I32 = torch.int32

# fold_in tag for the start-vertex draw; step draws use tags [0, length),
# so any walk length below 2**31 - 1 cannot collide with it
_START_TAG = 0x7FFFFFFF

__all__ = ["walk_keys", "walk_from", "random_walks", "walk_batch"]


def walk_keys(key: torch.Tensor, ids) -> torch.Tensor:
    """Per-walk base keys ``(n, 2)``: ``fold_in(key, id)`` for each int32
    walk id."""
    ids = torch.as_tensor(ids, device=key.device).to(I32)
    return prng.fold_in(key, ids)


def walk_from(offsets: torch.Tensor, targets: torch.Tensor,
              keys: torch.Tensor, starts, *, length: int) -> torch.Tensor:
    """Walks of ``length`` vertices from explicit ``starts``.

    ``keys`` are per-walk base keys (:func:`walk_keys`); ``starts`` is a
    matching ``(n,)`` int32 vector.  Returns ``(n, length)`` int32
    sequences on ``offsets``' device whose first column is ``starts``.
    Each step samples a neighbor uniformly from the current vertex's
    adjacency; a dead end (out-degree 0) self-loops.
    """
    dev = offsets.device
    cur = torch.as_tensor(starts, device=dev).to(I32)
    keys = keys.to(dev)
    n, e = cur.shape[0], targets.shape[0]
    out = torch.empty((n, length), dtype=I32, device=dev)
    if length == 0:
        return out
    out[:, 0] = cur
    steps = torch.arange(length - 1, dtype=torch.int64, device=dev)
    higher, lower = prng.randint_words(
        prng.fold_in(keys[:, None, :], steps))           # (n, length - 1)
    for s in range(length - 1):
        lo, deg = row_bounds(cur, offsets)
        r = prng.randint_from_words(higher[:, s], lower[:, s], 0,
                                    deg.clamp(min=1))
        if e:
            nxt = targets[(lo + r).clamp(0, e - 1)]
            cur = torch.where(deg > 0, nxt, cur)
        out[:, s + 1] = cur
    return out


def random_walks(offsets: torch.Tensor, targets: torch.Tensor,
                 key: torch.Tensor, *, num_walks: int, length: int,
                 num_vertices: int, walk_offset: int = 0) -> torch.Tensor:
    """-> ``(num_walks, length)`` int32 vertex sequences with random
    starts, on ``offsets``' device.  Walk ``i`` is a pure function of
    ``fold_in(key, walk_offset + i)`` and the CSR."""
    dev = offsets.device
    ids = wrap_int32(int(walk_offset)
                     + torch.arange(num_walks, dtype=torch.int64, device=dev))
    keys = walk_keys(key.to(dev), ids)
    starts = prng.randint(prng.fold_in(keys, _START_TAG), 0,
                          int(num_vertices))
    return walk_from(offsets, targets, keys, starts, length=length)


def walk_batch(csr, cfg, batch: int, seq: int, step: int, *, seed: int = 99,
               walk_offset: int = 0) -> dict:
    """Training batch from walks over ``csr`` (a port :class:`CSR`):
    tokens = vertex ids mod ``cfg.vocab_size``; int32 ``(batch, seq)``
    ``tokens`` and next-token ``labels`` on the CSR's device."""
    key = prng.fold_in(prng.key(seed, device=csr.offsets.device), step)
    walks = random_walks(csr.offsets, csr.targets, key, num_walks=batch,
                         length=seq + 1, num_vertices=csr.num_vertices,
                         walk_offset=walk_offset)
    toks = walks % cfg.vocab_size
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
