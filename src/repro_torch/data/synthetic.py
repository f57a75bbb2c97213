"""Deterministic synthetic LM batches (step-indexed for restart replay);
the port of ``repro/data/synthetic.py``.

Keys, token ids and labels are ``jax.random``'s bit for bit
(``data/prng.py``).  Frames and image embeddings are normal draws: their
uniform draw is bitwise, but ``torch.erfinv`` is not XLA's f32
polynomial, so they differ from the reference's in the last bits.
"""
from __future__ import annotations

from ..core.env import resolve_device
from . import prng


def synthetic_batch(cfg, batch: int, seq: int, step: int, *, device=None):
    """Pure function of (config, step): restart at step n replays exactly.
    Tensors on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    k1, k2 = prng.split(prng.fold_in(prng.key(1234, device=dev), step))
    if cfg.embed_stub:
        return {"frames": prng.normal(k1, (batch, seq, cfg.d_model)),
                "labels": prng.randint(k2, 0, cfg.vocab_size,
                                       shape=(batch, seq))}
    toks = prng.randint(k1, 0, cfg.vocab_size, shape=(batch, seq + 1))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.num_image_tokens:
        out["image_embeds"] = prng.normal(
            k2, (batch, cfg.num_image_tokens, cfg.d_model))
    return out
