"""The ``linear_scan`` op: ``h_t = a_t * h_{t-1} + b_t`` over ``(B, T,
C)``, registered as ``repro::linear_scan``.

A CPU tensor takes the plain version (``ref.linear_scan_ref``, the
reference's associative scan); a CUDA tensor launches the kernel or
raises, on PyTorch's current stream, and counts the launch in
``_lib.LAUNCHES["linear_scan"]``.  An input with no element returns an
empty ``h`` without a launch.  The fake implementation lets the op run on
fake tensors (the dry run's step); the autograd formula is the same scan
run the other way:

    g_t = gh_t + a_{t+1} * g_{t+1}   (a shifted by one, reversed)
    da_t = g_t * h_{t-1},  db = g,  dh0 = a_0 * g_0

(reversed forward: the mirror image).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _lib
from .kernel import linear_scan_kernel
from .ref import linear_scan_ref

# another copy of the package (a second checkout imported under another
# name) registers its op under its own namespace
NAMESPACE = ("repro" if __name__.startswith("repro_torch.")
             else __name__.split(".")[0])


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must be (B, T, C) of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be (B, C) = {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")
    if not (a.dtype == b.dtype == h0.dtype) or not a.is_floating_point():
        raise ValueError(f"a, b and h0 must share one float dtype, got "
                         f"{a.dtype}, {b.dtype} and {h0.dtype}")


@torch.library.custom_op(f"{NAMESPACE}::linear_scan", mutates_args=(),
                         device_types="cpu")
def linear_scan_op(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    _check(a, b, h0)
    return linear_scan_ref(a, b, h0, reverse).contiguous()


@linear_scan_op.register_kernel("cuda")
def _linear_scan_cuda(a, b, h0, reverse=False):
    _check(a, b, h0)
    for t, name in ((a, "a"), (b, "b"), (h0, "h0")):
        _lib.require(t, torch.float32, name)
    _lib.check_device(a)
    if a.numel() == 0:
        return torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = linear_scan_kernel(a.contiguous(), b.contiguous(), h0.contiguous(),
                           reverse)
    _lib.LAUNCHES["linear_scan"] += 1
    return h


@linear_scan_op.register_fake
def _linear_scan_fake(a, b, h0, reverse=False):
    _check(a, b, h0)
    return torch.empty(a.shape, dtype=a.dtype, device=a.device)


def _setup_context(ctx, inputs, output):
    a, _b, h0, reverse = inputs
    ctx.reverse = reverse
    ctx.save_for_backward(a, h0, output)


def _backward(ctx, gh):
    a, h0, h = ctx.saved_tensors
    if a.shape[1] == 0:
        return torch.zeros_like(a), torch.zeros_like(a), \
            torch.zeros_like(h0), None
    zero = torch.zeros_like(a[:, :1])
    if ctx.reverse:
        shifted = torch.cat([zero, a[:, :-1]], dim=1)
        prev = torch.cat([h[:, 1:], h0[:, None]], dim=1)
        end = -1
    else:
        shifted = torch.cat([a[:, 1:], zero], dim=1)
        prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
        end = 0
    g = linear_scan_op(shifted, gh.contiguous(), torch.zeros_like(h0),
                       not ctx.reverse)
    return g * prev, g, a[:, end] * g[:, end], None


linear_scan_op.register_autograd(_backward, setup_context=_setup_context)


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *,
                reverse: bool = False) -> torch.Tensor:
    """``h`` ``(B, T, C)`` with ``h_t = a_t * h_{t-1} + b_t`` from ``h0``
    ``(B, C)`` (zeros when None); ``reverse`` runs it from the end, ``h_t
    = a_t * h_{t+1} + b_t``.  On CUDA ``a``, ``b`` and ``h0`` are f32."""
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[-1]))
    return linear_scan_op(a, b, h0, reverse)
