"""Launch of the ``linear_scan`` CUDA kernel (``csrc/linear_scan.cu``).

Replaces no Pallas kernel: it stands where the reference runs XLA's
``jax.lax.associative_scan`` over a recurrent layer's chunk
(``repro/models/mamba.py:61``, ``repro/models/rglru.py:75``).  One kernel
a call.
"""
from __future__ import annotations

import torch

from .. import _lib


def linear_scan_kernel(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                       reverse: bool) -> torch.Tensor:
    """Contiguous CUDA f32 ``a``, ``b`` ``(B, T, C)`` and ``h0`` ``(B,
    C)`` -> ``h`` ``(B, T, C)`` f32."""
    rows, steps, channels = a.shape
    h = torch.empty((rows, steps, channels), dtype=torch.float32,
                    device=a.device)
    status = _lib.lib().repro_linear_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(), rows,
        steps, channels, int(reverse), _lib.stream_of(a))
    _lib.check(status, "linear_scan launch")
    return h
