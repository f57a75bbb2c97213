"""Feed-forward variants: SwiGLU / GeGLU / squared-ReLU / GELU; the port of
``repro/models/mlp.py``.

Products take bf16 in and give bf16 out; the activation runs in f32, is
cast to bf16 and then multiplied in bf16 (the reference's sequence).  SiLU
is ``x * sigmoid(x)`` as ``jax.nn.silu``; GELU is the tanh form,
``jax.nn.gelu``'s default.

Under tensor parallelism (``distributed/tensor_parallel.py``) ``w_in`` and
``w_gate`` are column-parallel and ``w_out`` row-parallel over ``d_ff``;
where ``tp`` does not divide ``d_ff`` the three stay whole and the layer
runs whole on every rank, with no collective.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tpar
from .layers import BF16, F32, dense_init, param, silu

KINDS = ("swiglu", "geglu", "relu2", "gelu")
GATED = ("swiglu", "geglu")


class MLP(torch.nn.Module):
    """``w_in (d, f)``, ``w_gate (d, f)`` for the gated kinds, ``w_out
    (f, d)``."""

    def __init__(self, d_model: int, d_ff: int, kind: str, *, device=None,
                 dtype=BF16):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.w_in = param((d_model, d_ff), device, dtype)
        self.w_out = param((d_ff, d_model), device, dtype)
        self.w_gate = param((d_model, d_ff), device, dtype) \
            if kind in GATED else None

    def init_(self, g: torch.Generator) -> None:
        """The reference's scales: ``1/sqrt(d)`` in, ``1/sqrt(f)`` out."""
        d, f = self.w_in.shape
        for w, scale in ((self.w_in, 1 / math.sqrt(d)),
                         (self.w_out, 1 / math.sqrt(f)),
                         (self.w_gate, 1 / math.sqrt(d))):
            if w is not None:
                w.copy_(dense_init(g, w.shape, scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x, self.kind)


def mlp_apply(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``p``: anything with ``w_in``/``w_out`` (and ``w_gate``), each cast
    to bf16 at its use (this rank's columns and rows where ``p.mg`` is
    set)."""
    mg = getattr(p, "mg", None)
    x = tpar.copy_to(x, mg)
    h = x @ p.w_in.to(BF16)
    if kind == "swiglu":
        g = x @ p.w_gate.to(BF16)
        h = silu(g.to(F32)).to(BF16) * h
    elif kind == "geglu":
        g = x @ p.w_gate.to(BF16)
        h = F.gelu(g.to(F32), approximate="tanh").to(BF16) * h
    elif kind == "relu2":       # nemotron squared-ReLU
        h = torch.square(torch.relu(h.to(F32))).to(BF16)
    elif kind == "gelu":
        h = F.gelu(h.to(F32), approximate="tanh").to(BF16)
    else:
        raise ValueError(kind)
    return tpar.row_parallel(h, p.w_out, mg)
