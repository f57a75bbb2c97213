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

With ``mesh`` a step is the reference's ``jax.jit`` of it with the batch
placed by ``batch_shardings`` (``launch/dryrun.py``'s ``build_cell``):
every rank passes the global batch and runs its rows of it
(``sharding.batch_axes``; the MoE layers route over the global token
order, ``fsdp.rows_over``), on a model sharded over the mesh
(``shard_model``, ``fsdp`` or not); its caches are its rows (the
``cache_placements`` of the batch), and the logits and next tokens come
back whole, gathered over the data axes.
"""
from __future__ import annotations

import math

import torch

from ..models.transformer import forward_decode, forward_prefill


def _check_tp(model, cfg, tp: int) -> None:
    have = getattr(model, "tp", 1)
    if cfg.padded_heads(have) != cfg.padded_heads(tp):
        raise ValueError(f"the model's heads are padded at tp={have} "
                         f"({cfg.padded_heads(have)}), the step's tp={tp} "
                         f"pads to {cfg.padded_heads(tp)}")


def _rows(mesh, batch, key):
    """``(data group or None, this rank's rows of the global batch)``
    over the data axes (``sharding.batch_axes``) of ``mesh``."""
    from ..distributed import fsdp
    from ..distributed.sharding import batch_axes, dp_axes, mesh_axes
    if mesh is None:
        return None, batch
    axes = mesh_axes(mesh)
    b = batch[key].shape[0]
    ba = batch_axes(axes, b)
    n_b = 1 if ba is None else math.prod(axes[a] for a in ba)
    if n_b == 1:
        return None, batch
    if n_b != math.prod(axes[a] for a in dp_axes(axes) if a in axes):
        raise NotImplementedError(f"a batch of {b} splits over {ba} alone, "
                                  f"not every data axis")
    dg = fsdp.data_group(mesh)
    n = b // n_b
    return dg, {k: v[dg.rank * n:(dg.rank + 1) * n] for k, v in batch.items()}


def _whole_rows(t: torch.Tensor, dg) -> torch.Tensor:
    from ..distributed import fsdp
    return t if dg is None else fsdp.all_gather_dim(t, 0, dg)


def make_prefill_step(cfg, max_seq: int, *, tp: int = 1, mesh=None):
    @torch.inference_mode()
    def prefill_step(model, batch):
        from ..distributed import fsdp
        _check_tp(model, cfg, tp)
        dg, mine = _rows(mesh, batch, next(iter(batch)))
        with fsdp.rows_over(model, dg):
            logits, caches = forward_prefill(model, mine, cfg, max_seq)
        return _whole_rows(logits, dg), caches
    return prefill_step


def make_decode_step(cfg, max_seq: int, *, tp: int = 1, greedy: bool = True,
                     mesh=None):
    """``greedy`` is the reference's flag, kept for its signature alone:
    both of its branches take the argmax, and so does this step."""
    @torch.inference_mode()
    def decode_step(model, caches, batch):
        from ..distributed import fsdp
        _check_tp(model, cfg, tp)
        dg, mine = _rows(mesh, batch, "token")
        with fsdp.rows_over(model, dg):
            logits, caches = forward_decode(model, mine, caches, cfg,
                                            max_seq)
        logits = _whole_rows(logits, dg)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches
    return decode_step
