"""Gradient compression: int8 quantization with error feedback; the
single-device half of ``repro/distributed/compression.py``
(``compressed_psum`` and ``compressed_allreduce`` wait for the
multi-device slice).

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payloads equal the reference's bitwise on the same f32 inputs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> (int8 payload, f32 scale): the scale maps ``max |x|`` to
    127."""
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(grads: Dict[str, torch.Tensor],
                           error_buf: Dict[str, torch.Tensor]):
    """Gradients plus the carried error -> (the dequantized gradients, the
    new error), leaf by leaf, as dicts keyed like ``grads``."""
    new_g, new_e = {}, {}
    for name, g in grads.items():
        g32 = g.to(F32) + error_buf[name]
        deq = dequantize_int8(*quantize_int8(g32))
        new_g[name] = deq.to(g.dtype)
        new_e[name] = g32 - deq
    return new_g, new_e


def init_error_buf(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A zero f32 error buffer per leaf."""
    return {n: torch.zeros(g.shape, dtype=F32, device=g.device)
            for n, g in grads.items()}
