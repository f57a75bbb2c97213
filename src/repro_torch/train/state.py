"""Training state; the port of ``repro/train/state.py``.

The reference's pytree leaves are, here, a model and dicts keyed by its
parameter names (``model.named_parameters()``): ``mu``/``nu`` are Adam's
moments and ``error`` the gradient compression's error feedback, each a
tensor of its parameter's shape.  ``checkpoint/io.py`` lays them out as
the reference's stacked leaves on disk.  A ZeRO-1 state
(``train.step.make_zero1_local_state``) keys its flat moments by the
reference's leaf paths instead.  On a model that
``distributed.tensor_parallel.shard_model`` has sharded, the moments and
the error buffer are the rank's pieces, as its parameters are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

Leaves = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor           # () int32, on the model's device
    params: torch.nn.Module      # f32 master weights (repro_torch.models)
    mu: Leaves                   # Adam first moment
    nu: Leaves                   # Adam second moment
    error: Optional[Leaves] = None   # gradient-compression error feedback


def zeros_like_params(model: torch.nn.Module, dtype=None) -> Leaves:
    """A zero tensor per parameter (of its dtype unless told), by name."""
    return {n: torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)
            for n, p in model.named_parameters()}


def init_state(model: torch.nn.Module, *,
               compression: bool = False) -> TrainState:
    """Step 0, zero moments of the params' dtype and, with
    ``compression``, a zero f32 error buffer."""
    step = torch.zeros((), dtype=torch.int32,
                       device=next(model.parameters()).device)
    err = zeros_like_params(model, torch.float32) if compression else None
    return TrainState(step, model, zeros_like_params(model),
                      zeros_like_params(model), err)


def abstract_state(cfg, *, tp: int = 1,
                   compression: bool = False) -> TrainState:
    """:func:`init_state` of an f32 model of ``cfg`` (heads padded at
    ``tp``) on the ``meta`` device: every shape and dtype, no storage."""
    from ..models.transformer import Transformer
    return init_state(Transformer(cfg, tp=tp, device="meta",
                                  dtype=torch.float32),
                      compression=compression)
