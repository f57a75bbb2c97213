"""train_step factory: loss -> grads -> clip -> (optional compression) ->
AdamW; the single-card half of ``repro/train/step.py`` (its shard_map
``make_local_accum_train_step`` waits for the multi-device slice).

Gradients come from ``loss.backward()`` into each parameter's ``.grad``
(f32).  With ``accum_steps > 1`` the batch splits into ``(accum,
B/accum)`` as the reference's does, each microbatch's backward adds its
gradients to the last (the reference's running sum), and the summed loss
and gradients are scaled by ``1/accum``.
"""
from __future__ import annotations

from typing import Optional

from ..distributed.compression import compress_with_feedback
from ..models.transformer import loss_fn
from .optimizer import (OptimizerConfig, adamw_update, clip_by_global_norm,
                        make_scratch)
from .state import TrainState


def make_train_step(cfg, oc: OptimizerConfig, *,
                    remat_policy: Optional[str] = "full",
                    compression: bool = False, accum_steps: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    model, moments and error buffer are updated in place and the step
    advances; ``metrics`` holds ``loss``, ``grad_norm`` (before the clip)
    and ``lr``, f32 scalars on the model's device."""

    def grads_of(model, batch):
        model.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = loss_fn(model, batch, cfg, remat_policy)
            loss.backward()
            loss = loss.detach()
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not split into "
                                 f"{accum_steps} microbatches")
            micro = {k: v.reshape((accum_steps, b // accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = None
            for i in range(accum_steps):
                li = loss_fn(model, {k: v[i] for k, v in micro.items()},
                             cfg, remat_policy)
                li.backward()
                loss = li.detach() if loss is None else loss + li.detach()
            inv = 1.0 / accum_steps
            loss = loss * inv
            for p in model.parameters():
                p.grad.mul_(inv)
        return loss, {n: p.grad for n, p in model.named_parameters()}

    def train_step(state: TrainState, batch):
        model = state.params
        dev = state.step.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        loss, grads = grads_of(model, batch)
        scratch = make_scratch(grads.values())
        grads, gnorm = clip_by_global_norm(grads, oc.clip_norm, scratch)
        error = state.error
        if compression:
            grads, error = compress_with_feedback(grads, error)
        params = dict(model.named_parameters())
        _, mu, nu, lr = adamw_update(params, grads, state.mu, state.nu,
                                     state.step, oc, scratch)
        del grads, scratch
        model.zero_grad(set_to_none=True)
        new_state = TrainState(state.step + 1, model, mu, nu, error)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
