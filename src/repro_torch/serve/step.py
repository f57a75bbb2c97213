"""Serving steps: prefill (prompt -> cache) and decode (one token); the
port of ``repro/serve/step.py``.

The reference memoizes ``jax.jit`` of each step per config, so engines
share one compiled program.  Eager PyTorch compiles nothing, so each call
here returns a plain closure.  Steps run under ``torch.inference_mode()``.
The next token is the first index of the maximum logit (``torch.argmax``,
as ``jnp.argmax``).

``tp`` is the reference's: the Q heads were padded at it (the model must
have been built at that ``tp``); a model that
``distributed.tensor_parallel.shard_model`` has sharded runs on its
rank's caches, and its logits come back whole (gathered over the ranks'
vocabulary columns where ``embed`` is split), so the next token is
``torch.argmax`` of them on every rank.
"""
from __future__ import annotations

import torch

from ..models.transformer import forward_decode, forward_prefill


def _check_tp(model, cfg, tp: int) -> None:
    have = getattr(model, "tp", 1)
    if cfg.padded_heads(have) != cfg.padded_heads(tp):
        raise ValueError(f"the model's heads are padded at tp={have} "
                         f"({cfg.padded_heads(have)}), the step's tp={tp} "
                         f"pads to {cfg.padded_heads(tp)}")


def make_prefill_step(cfg, max_seq: int, *, tp: int = 1):
    @torch.inference_mode()
    def prefill_step(model, batch):
        _check_tp(model, cfg, tp)
        return forward_prefill(model, batch, cfg, max_seq)
    return prefill_step


def make_decode_step(cfg, max_seq: int, *, tp: int = 1, greedy: bool = True):
    """``greedy`` is the reference's flag, kept for its signature alone:
    both of its branches take the argmax, and so does this step."""
    @torch.inference_mode()
    def decode_step(model, caches, batch):
        _check_tp(model, cfg, tp)
        logits, caches = forward_decode(model, batch, caches, cfg, max_seq)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches
    return decode_step
