"""Plain PyTorch version of the ``exclusive_scan`` kernel."""
from __future__ import annotations

import torch

from ..parse_edges.ref import wrap32


def exclusive_scan_ref(x: torch.Tensor):
    """``(exclusive prefix sums, total)`` of an int32 vector, wrapping in
    int32 like the reference's ``jnp.cumsum``."""
    if x.shape[0] == 0:
        return x.clone(), torch.zeros((), dtype=torch.int32, device=x.device)
    incl = torch.cumsum(x.to(torch.int64), 0)
    return wrap32(incl - x), wrap32(incl[-1])
