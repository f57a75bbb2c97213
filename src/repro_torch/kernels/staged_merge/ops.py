"""Public wrappers of the staged build's pair sort and merge kernel.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
CUDA code or raises.  No pair (n = 0) launches nothing.  The merge counts
its launches in ``_lib.LAUNCHES["staged_merge"]``; the sort is CUB's and
counts none.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _lib
from .kernel import sort_pairs_kernel, staged_merge_kernel
from .ref import sort_pairs_ref, staged_merge_ref


def _check_vectors(n: int, **named) -> None:
    for name, t in named.items():
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                             f"{n}, got {tuple(t.shape)}")


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor,
               keys_alt: torch.Tensor, vals_alt: torch.Tensor, *,
               bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of the int32 pairs ``(keys, vals)`` by the keys' low
    ``bits`` bits (1 to 31; the keys are non-negative), in the two buffer
    pairs given: all four may be overwritten, and the result is returned as
    views of whichever pair holds it."""
    n = keys.shape[0]
    _check_vectors(n, keys=keys, vals=vals, keys_alt=keys_alt,
                   vals_alt=vals_alt)
    if not 1 <= bits <= 31:
        raise ValueError(f"bits must be in [1, 31], got {bits}")
    if keys.device.type == "cpu":
        return sort_pairs_ref(keys, vals, keys_alt, vals_alt, bits=bits)
    for name, t in (("keys", keys), ("vals", vals), ("keys_alt", keys_alt),
                    ("vals_alt", vals_alt)):
        _lib.require(t, torch.int32, name)
    _lib.check_device(keys)
    if n == 0:
        return keys, vals
    return sort_pairs_kernel(keys, vals, keys_alt, vals_alt, bits)


def staged_merge(keys: torch.Tensor, vals: torch.Tensor,
                 delta: torch.Tensor, *, dst: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fresh int32 targets of n sorted pairs: the pair at i with key
    ``k < len(delta)`` goes to ``i + delta[k]``, padding leaves -1 at ``i``
    (see ``staged_merge_ref``).  With ``dst`` and ``weights`` the values are
    positions in them and both are gathered (the weights come back too)."""
    n = keys.shape[0]
    _check_vectors(n, keys=keys, vals=vals)
    _check_vectors(delta.shape[0], delta=delta)
    if (dst is None) != (weights is None):
        raise ValueError("dst and weights are given together or not at all")
    if dst is not None:
        _check_vectors(n, dst=dst, weights=weights)
    if keys.device.type == "cpu":
        return staged_merge_ref(keys, vals, delta, dst=dst, weights=weights)
    for name, t in (("keys", keys), ("vals", vals), ("delta", delta),
                    ("dst", dst)):
        if t is not None:
            _lib.require(t, torch.int32, name)
    if weights is not None:
        _lib.require(weights, torch.float32, "weights")
    _lib.check_device(keys)
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=keys.device),
                None if weights is None else weights.new_empty(0))
    out = staged_merge_kernel(keys, vals, delta, dst, weights)
    _lib.LAUNCHES["staged_merge"] += 1
    return out
