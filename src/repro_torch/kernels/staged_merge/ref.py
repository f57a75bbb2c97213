"""Plain PyTorch versions of the staged build's pair sort and merge.

``staged_merge_ref`` is the merge of ``repro/core/build.py::csr_staged``
(destination = offsets[u] + before[p][u] + rank, a scatter whose padding
slots keep -1 and weight 0) written over the sorted pairs and one table, as
the ``staged_merge`` kernel computes it."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sort_pairs_ref(keys: torch.Tensor, vals: torch.Tensor,
                   keys_alt: torch.Tensor, vals_alt: torch.Tensor, *,
                   bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of the pairs ``(keys[i], vals[i])`` by the keys' low
    ``bits`` bits, in place; returns ``(keys, vals)``.  The kernel may leave
    the result in ``(keys_alt, vals_alt)`` instead; this version never
    touches them."""
    order = torch.argsort(keys & ((1 << bits) - 1), stable=True)
    keys.copy_(keys[order])
    vals.copy_(vals[order])
    return keys, vals


def staged_merge_ref(keys: torch.Tensor, vals: torch.Tensor,
                     delta: torch.Tensor, *,
                     dst: Optional[torch.Tensor] = None,
                     weights: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Targets (and weights) of the sorted pairs: the pair at position i
    with key ``k < len(delta)`` lands at ``i + delta[k]``; a key at or above
    it is padding and leaves -1 (weight 0) at ``i``.  Unweighted, the values
    are the targets; with ``dst`` and ``weights``, the values are the edges'
    positions in them."""
    n, num_keys = keys.shape[0], delta.shape[0]
    pos = torch.arange(n, device=keys.device)
    valid = keys < num_keys
    slot = pos
    if num_keys:
        slot = torch.where(valid, pos + delta[keys.clamp(max=num_keys - 1)],
                           pos)
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    w_out = None
    if dst is None:
        out[slot] = torch.where(valid, vals, -1)
    else:
        at = vals.long()
        out[slot] = torch.where(valid, dst[at], -1)
        w_out = torch.empty(n, dtype=weights.dtype, device=keys.device)
        w_out[slot] = torch.where(valid, weights[at],
                                  weights.new_zeros(()))
    return out, w_out
