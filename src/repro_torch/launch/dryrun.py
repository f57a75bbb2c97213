"""One (arch x shape) cell's step and its inputs on a mesh; the port of
``repro/launch/dryrun.py``'s ``build_cell``.

The reference lowers and compiles each cell against abstract inputs on a
production mesh; the port has no lowering, so :func:`build_cell` returns
the eager step and its arguments on the ``meta`` device (every shape and
dtype, no storage: the reference's ``ShapeDtypeStruct``s).
Its defaults are the reference's: ``fsdp`` for ``FSDP_ARCHS``, a bf16
state for ``BF16_STATE_ARCHS``, ``shapes.default_accum``.
"""
from __future__ import annotations

import torch

BF16 = torch.bfloat16
F32 = torch.float32
LOCAL_MODES = ("local_accum", "local_accum_int8", "local_zero1")


def build_cell(cfg, shape: str, mesh, *, remat_policy="full",
               accum: int | None = None, fsdp: bool | None = None,
               step_mode: str = "gspmd"):
    """Returns ``(fn, args, meta)``: the step of ``shape``'s kind on this
    rank of ``mesh`` (a ``("data", "model")`` ``DeviceMesh``), its
    arguments (``(state, batch)``, ``(model, batch)`` or ``(model,
    caches, batch)``; the batch global, the rest this rank's pieces) and
    ``{"accum", "fsdp", "step_mode"}`` (train) or ``{"fsdp"}``.

    * train: ``train.step.make_train_step(..., mesh=mesh)`` (``gspmd``)
      on ``init_state(model, mesh=mesh)``, or the local-accumulation step
      of ``step_mode`` (``fsdp=False`` only);
    * prefill and decode: ``serve.step``'s steps with ``mesh`` on a bf16
      serving model (every leaf bf16 for a bf16-state arch), the decode's
      caches this rank's rows and pieces.

    The model is ``Transformer(cfg, tp=...)`` on the ``meta`` device,
    sharded by ``shard_model(..., fsdp=fsdp)``."""
    from ..configs import BF16_STATE_ARCHS, FSDP_ARCHS
    from ..distributed import tensor_parallel as tpar
    from ..distributed.sharding import batch_axes, mesh_axes
    from ..models.transformer import Transformer, init_caches
    from ..serve.step import make_decode_step, make_prefill_step
    from ..train.optimizer import OptimizerConfig
    from ..train.state import cast_model, init_state
    from .shapes import SHAPES, default_accum, input_specs

    sc = SHAPES[shape]
    axes = mesh_axes(mesh)
    tp = axes.get("model", 1)
    if fsdp is None:
        fsdp = cfg.name in FSDP_ARCHS
    bf16_state = cfg.name in BF16_STATE_ARCHS
    train = sc.kind == "train"
    model = Transformer(cfg, tp=tp, device="meta",
                        dtype=F32 if train else BF16)
    if bf16_state:
        cast_model(model, BF16)
        if not train:
            model.requires_grad_(False)
    tpar.shard_model(model, cfg, mesh, fsdp=fsdp)
    batch = input_specs(cfg, shape)

    if train:
        if accum is None:
            accum = default_accum(cfg, shape, mesh)
        oc = OptimizerConfig()
        meta = {"accum": accum, "fsdp": fsdp, "step_mode": step_mode}
        if step_mode == "gspmd":
            from ..train.step import make_train_step
            step = make_train_step(cfg, oc, remat_policy=remat_policy,
                                   accum_steps=accum, mesh=mesh)
            return step, (init_state(model, mesh=mesh), batch), meta
        if step_mode not in LOCAL_MODES:
            raise ValueError(f"unknown step_mode {step_mode!r}")
        if fsdp:
            raise NotImplementedError("the local-accumulation step keeps "
                                      "the parameters whole over the data "
                                      "axes: fsdp=False")
        from ..distributed.sharding import dp_axes
        from ..train.step import (make_local_accum_train_step,
                                  make_zero1_local_state)
        zero1 = step_mode == "local_zero1"
        step = make_local_accum_train_step(
            cfg, oc, mesh, remat_policy=remat_policy, accum_steps=accum,
            int8_allreduce=step_mode.endswith("int8"), zero1=zero1,
            batch_axes=("data",) if zero1 else dp_axes(axes))
        state = make_zero1_local_state(model, axes["data"], tp, mesh=mesh) \
            if zero1 else init_state(model)
        return step, (state, batch), meta

    if sc.kind == "prefill":
        step = make_prefill_step(cfg, sc.seq, tp=tp, mesh=mesh)
        return step, (model, batch), {"fsdp": fsdp}

    ba = batch_axes(axes, sc.global_batch)
    rows = sc.global_batch
    for a in ba or ():
        rows //= axes[a]
    caches = init_caches(cfg, rows, sc.seq, device="meta", tp=tp)
    step = make_decode_step(cfg, sc.seq, tp=tp, mesh=mesh)
    return step, (model, caches, batch), {"fsdp": fsdp}
