"""Serving steps: prefill (prompt -> cache) and decode (one token); the
port of ``repro/serve/step.py``.

The reference memoizes ``jax.jit`` of each step per config, so engines
share one compiled program.  Eager PyTorch compiles nothing, so each call
here returns a plain closure.  Steps run under ``torch.inference_mode()``.
The next token is the first index of the maximum logit (``torch.argmax``,
as ``jnp.argmax``).
"""
from __future__ import annotations

import torch

from ..models.transformer import forward_decode, forward_prefill


def make_prefill_step(cfg, max_seq: int):
    @torch.inference_mode()
    def prefill_step(model, batch):
        return forward_prefill(model, batch, cfg, max_seq)
    return prefill_step


def make_decode_step(cfg, max_seq: int):
    @torch.inference_mode()
    def decode_step(model, caches, batch):
        logits, caches = forward_decode(model, batch, caches, cfg, max_seq)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches
    return decode_step
