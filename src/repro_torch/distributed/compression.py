"""Gradient compression: int8 quantization with error feedback, and the
int8 all-reduce over a mesh axis; the port of
``repro/distributed/compression.py``.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payloads equal the reference's bitwise on the same f32 inputs.  The scale
is ``max |x|`` times ``1/127`` rounded to f32: XLA compiles the
reference's ``/ 127.0`` into that product, which differs from the
quotient in the last place for some maxima.

:func:`compressed_allreduce` is the wire-efficient schedule: each rank
quantizes its padded ``(n, seg)`` tensor with one scale, sends segment
``k`` to rank ``k`` as int8 (``all_to_all_single``) and gathers the
scales, sums the ``n`` dequantized segments it received in f32 in rank
order (each term added as XLA fuses the reference's sum, through f64:
:func:`fma_`), quantizes the sum again and all-gathers the int8
result and its scale: about ``2 P`` bytes on the wire where an f32
all-reduce moves ``8 P``.  :func:`compressed_psum` quantizes once and
all-reduces the dequantized values: the accuracy of the quantization apart
from the schedule.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from .collectives import all_gather_flat, axis_group

F32 = torch.float32
# elements a quantization pass converts at a time: its f32 temporary stays
# 64 MB where a stacked leaf at full width is 3.2 GB
CHUNK = 1 << 24
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=F32))   # as XLA folds it


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> (int8 payload, f32 scale): the scale maps ``max |x|`` to
    127 (``max |x| * INV_127``).  ``max |x|`` is ``max(-min x, max x)``
    (exact, no ``|x|`` temporary) and the payload is made ``CHUNK``
    elements at a time."""
    lo, hi = torch.aminmax(x)
    scale = torch.clamp_min(torch.maximum(-lo, hi), 1e-12) * INV_127
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    for src, dst in zip(x.reshape(-1).split(CHUNK), q.view(-1).split(CHUNK)):
        dst.copy_(torch.div(src, scale).round_().clamp_(-127, 127))
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


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``mesh``'s ``axis`` of every rank's int8-quantized
    ``x``, in f32 (an all-reduce of the dequantized values)."""
    group, _n, _k = axis_group(mesh, axis)
    out = dequantize_int8(*quantize_int8(x))
    dist.all_reduce(out, group=group)
    return out


def compressed_allreduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``mesh``'s ``axis`` of every rank's ``x`` by the int8
    schedule (module docstring): f32, of ``x``'s shape.  Two
    quantizations, each with one scale per rank, bound the error."""
    group, n, _k = axis_group(mesh, axis)
    size = x.numel()
    flat = torch.zeros(-(-size // n) * n, dtype=F32, device=x.device)
    flat[:size].copy_(x.reshape(-1))
    int8_allreduce_(flat, group)
    return flat[:size].view(x.shape)


def fma_(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """``acc += q * scale`` as the fused multiply-add XLA's compiled
    reduction emits, to within double rounding: the product of an int8
    and an f32 is exact in f64, and the sum is rounded twice, to f64 and
    then to f32 (``CHUNK`` elements at a time).  That can differ from the
    single rounding of a true FMA where the f64 sum falls on a tie between
    two f32 values."""
    s = scale.to(torch.float64)
    for a, b in zip(acc.split(CHUNK), q.split(CHUNK)):
        a.copy_(torch.addcmul(a.to(torch.float64), b.to(torch.float64), s))


def int8_allreduce_(flat: torch.Tensor, group) -> None:
    """:func:`compressed_allreduce` in place on a 1-D f32 buffer whose
    length the group's size divides (the padding zeros already in it): the
    training step's form, which holds no second buffer of its size."""
    n = group.size()
    q, s = quantize_int8(flat.view(n, -1))
    shards = torch.empty_like(q)
    dist.all_to_all_single(shards, q, group=group)
    del q
    scales = torch.empty(n, dtype=F32, device=flat.device)
    all_gather_flat(scales, s.reshape(1), group)
    summed = torch.mul(shards[0], scales[0])
    for j in range(1, n):
        fma_(summed, shards[j], scales[j])
    q2, s2 = quantize_int8(summed)
    del summed
    all_gather_flat(shards.view(-1), q2, group)
    all_gather_flat(scales, s2.reshape(1), group)
    torch.mul(shards, scales[:, None], out=flat.view(n, -1))
