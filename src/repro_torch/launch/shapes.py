"""The assigned input shapes of each (arch x shape) cell and their
abstract inputs; the port of ``repro/launch/shapes.py``.

  train_4k      seq 4096,    global_batch 256   -> train_step
  prefill_32k   seq 32768,   global_batch 32    -> prefill_step
  decode_32k    seq 32768,   global_batch 128   -> decode_step
  long_500k     seq 524288,  global_batch 1     -> decode_step
                (sub-quadratic archs only; full-attention archs skip)

:func:`input_specs` gives the global batch as tensors on the ``meta``
device (the reference's ``ShapeDtypeStruct``s: shapes and dtypes, no
storage).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import torch

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def case_of(shape: Union[str, ShapeCase]) -> ShapeCase:
    """A shape's case: by its name in :data:`SHAPES`, or a
    :class:`ShapeCase` of another size as it is (the tests' small
    cells)."""
    return shape if isinstance(shape, ShapeCase) else SHAPES[shape]


def cell_enabled(cfg, shape: str) -> bool:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False           # pure full attention: documented skip
    return True


def input_specs(cfg, shape: Union[str, ShapeCase]
                ) -> Dict[str, torch.Tensor]:
    """The global batch of ``shape`` for ``cfg`` (token/frame/image
    stand-ins) as tensors of the reference's shapes and dtypes."""
    sc = case_of(shape)
    b, s = sc.global_batch, sc.seq

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if sc.kind in ("train", "prefill"):
        batch = {}
        if cfg.embed_stub:
            batch["frames"] = sd((b, s, cfg.d_model), F32)
        else:
            batch["tokens"] = sd((b, s), I32)
        if sc.kind == "train":
            batch["labels"] = sd((b, s), I32)
        if cfg.num_image_tokens:
            batch["image_embeds"] = sd((b, cfg.num_image_tokens,
                                        cfg.d_model), F32)
        return batch
    return {"token": sd((b,), I32), "pos": sd((b,), I32)}


def _axes(mesh) -> Mapping[str, int]:
    """A ``DeviceMesh``'s ``{axis: size}``, or the mapping itself."""
    if hasattr(mesh, "mesh_dim_names"):
        from ..distributed.sharding import mesh_axes
        return mesh_axes(mesh)
    return dict(mesh)


def default_accum(cfg, shape: Union[str, ShapeCase],
                  mesh: Union[Mapping[str, int], object]) -> int:
    """Gradient-accumulation heuristic: keep the per-device microbatch's
    layer-boundary residuals under ~2 GB.  ``mesh``: a ``DeviceMesh`` or
    a dict of axis sizes (``{"data": 16, "model": 16}``)."""
    from ..distributed.sharding import _axsize, batch_axes
    sc = case_of(shape)
    if sc.kind != "train":
        return 1
    axes = _axes(mesh)
    ba = batch_axes(axes, sc.global_batch)
    b_local = sc.global_batch // _axsize(axes, ba)
    bytes_per_layer = sc.seq * cfg.d_model * 2
    budget = 2 << 30
    live = b_local * bytes_per_layer * max(cfg.num_layers, 1)
    accum = 1
    while live // accum > budget and accum < b_local:
        accum *= 2
    while sc.global_batch % accum or (sc.global_batch // accum) % max(
            _axsize(axes, ba), 1):
        accum //= 2
    return max(accum, 1)

