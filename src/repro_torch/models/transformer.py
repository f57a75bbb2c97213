"""Model stack: init, train, prefill and decode; the port of
``repro/models/transformer.py``.

A :class:`Transformer` holds the tied embedding and every matrix in its
``dtype`` and the norm scales (and the recurrent kinds' ``lam``,
``A_log``, ``D``, ``dt_bias``) in f32.  The reference keeps f32 params
and casts each matrix to bf16 at every use; the port casts at every use
too (``w.to(BF16)``).  A training model is f32 (master weights, with
gradients): the bf16 cotangent of each use widens to f32 and the uses
sum in f32, as in the reference, which matters for the tied embedding (a
gather from the f32 table and the head).  A serving model is bf16, held
once: there the cast returns the same tensor and launches nothing.
:func:`init_params` draws the weights on the model's device from a
``torch.Generator``; :func:`params_from_jax` carries the JAX package's
param pytree over, unstacking its per-segment leading axis.

Caches are a list with one dict per layer in execution order (each
kind's, ``models/blocks.py``); :func:`forward_decode` updates them in
place.  :func:`forward_train` checkpoints the reference's remat unit, one
repetition of a segment's pattern, under a policy of
:data:`REMAT_POLICIES` (``torch.utils.checkpoint``, non-reentrant); a
policy changes memory, never values.

``tp`` pads the Q heads to ``cfg.padded_heads(tp)``, as the reference's
``init_params(key, cfg, tp)``; the forward code is the same at every
``tp``.  A model ``distributed.tensor_parallel.shard_model`` has sharded
runs each layer's share on its rank; where the rules split ``embed`` over
``"model"`` the embedding is vocab-parallel (each rank looks up the
tokens in its rows, the rows summed over the group), the tied head gives
the rank's columns of the logits, :func:`loss_fn` is a vocab-parallel
cross-entropy (the max, the sum of exponentials and the target logit each
reduced over the group: the ``(B, S, V)`` logits are never gathered), and
the prefill and decode gather their ``(B, V)`` logits.  Where the data
axes split the embedding too (FSDP, ``distributed/fsdp.py``), the lookup
and the head each gather it whole at their use.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.env import resolve_device
from ..distributed import fsdp
from ..distributed import tensor_parallel as tpar
from . import attention as attn
from . import blocks
from .layers import (BF16, F32, dense_init, embed_lookup, param, rms_norm,
                     rope_tables)

Caches = List[Dict[str, torch.Tensor]]
_aten = torch.ops.aten


def _saving(ops):
    """A selective-checkpoint policy that keeps the outputs of ``ops`` and
    recomputes the rest."""
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _save_all(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE


# the reference's jax.checkpoint policies: a dot with batch dimensions is a
# bmm here (attention scores, MoE experts), one without an mm; None
# checkpoints the whole unit (saves nothing extra)
REMAT_POLICIES = {
    "full": None,
    "dots": _saving({_aten.mm.default, _aten.bmm.default}),
    "dots_no_batch": _saving({_aten.mm.default}),
    "nothing": None,
    "everything": _save_all,
}


class Transformer(torch.nn.Module):
    """``embed (V, D)`` (tied with the head), ``final_norm (D,)`` and one
    :class:`~.blocks.Block` per layer in execution order, the Q heads
    padded at ``tp``.  ``dtype`` is the matrices' (bf16 to serve; f32 to
    train, and then every parameter requires a gradient)."""

    def __init__(self, cfg, *, tp: int = 1, device=None, dtype=BF16):
        super().__init__()
        if dtype not in (BF16, F32):
            raise ValueError(f"a model's dtype is bf16 or f32, not {dtype}")
        self.cfg, self.tp = cfg, tp
        self.embed = param((cfg.vocab_size, cfg.d_model), device, dtype)
        self.final_norm = param((cfg.d_model,), device, F32)
        self.layers = torch.nn.ModuleList(
            blocks.Block(kind, cfg, tp=tp, device=device, dtype=dtype)
            for kind in blocks.layer_kinds(cfg))
        self.requires_grad_(dtype == F32)

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg, seed: int = 0, *, tp: int = 1, device=None,
                dtype=BF16) -> Transformer:
    """A model with the reference's init scales (Q heads padded at ``tp``,
    the padded heads zero), drawn on ``device`` (default CUDA) from
    ``torch.Generator(device).manual_seed(seed)``; ``dtype=F32`` gives
    trainable f32 master weights."""
    dev = resolve_device(device)
    model = Transformer(cfg, tp=tp, device=dev, dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    d = cfg.d_model
    model.embed.copy_(dense_init(g, model.embed.shape, d ** -0.5))
    model.final_norm.zero_()
    for layer in model.layers:
        layer.init_(g)
    return model


def _leaves(tree, prefix: str = "") -> Dict[str, object]:
    """A nested dict's leaves under their dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@torch.no_grad()
def params_from_jax(tree, cfg, device=None, dtype=BF16, *,
                    tp: int = 1) -> Transformer:
    """The JAX package's ``init_params(key, cfg, tp)`` pytree (numpy
    arrays, f32) as a :class:`Transformer` of ``dtype`` on ``device``
    (default CUDA), its heads padded at ``tp``.
    Segment ``si``'s params are stacked over a leading axis ``n``; layer
    ``j`` of the segment takes index ``j`` of every leaf
    (:func:`reference_paths`).  A block's parameter names are the
    pytree's dotted paths (``attn.wq``, ``moe.w_in``, ``rglru.lam``,
    ``mamba.A_log``, ``xattn.wo``, ``mlp.w_gate``, ``norm2``); a leaf
    missing on either side or of another shape raises ``ValueError``."""
    dev = resolve_device(device)
    model = Transformer(cfg, tp=tp, device=dev, dtype=dtype)
    src, paths = _leaves(tree), reference_paths(model)
    want = {path for path, _ in paths.values()}
    if set(src) != want:
        raise ValueError(f"params_from_jax: the tree has leaves "
                         f"{sorted(set(src) - want)} the model lacks and "
                         f"lacks {sorted(want - set(src))}")
    for name, w in model.named_parameters():
        path, j = paths[name]
        arr = np.array(src[path] if j is None else np.asarray(src[path])[j],
                       dtype=np.float32)            # a writable copy
        what = path if j is None else f"{path}[{j}]"
        if tuple(arr.shape) != tuple(w.shape):
            raise ValueError(f"params_from_jax: {what} has shape "
                             f"{arr.shape}, the model wants {tuple(w.shape)}")
        w.copy_(torch.from_numpy(arr))
    return model


def reference_paths(model: Transformer) -> Dict[str, Tuple[str, Optional[int]]]:
    """Each parameter's name in ``model`` -> (the dotted path of its leaf
    in the reference's params pytree, its index along that leaf's stacked
    layer axis; None for ``embed`` and ``final_norm``):
    ``layers.5.attn.wq`` of phi4-mini is ``("seg0.sub0.attn.wq", 5)``."""
    slots = [(si, j, i) for si, (pattern, n) in enumerate(
        blocks.plan_segments(model.cfg)) for j in range(n)
        for i in range(len(pattern))]       # each layer's place in the scan
    out = {}
    for name, _ in model.named_parameters():
        if name.startswith("layers."):
            _, k, rest = name.split(".", 2)
            si, j, i = slots[int(k)]
            out[name] = (f"seg{si}.sub{i}.{rest}", j)
        else:
            out[name] = (name, None)
    return out


def stacked_rank(name: str, p: torch.Tensor) -> int:
    """The rank of ``p``'s leaf in the reference, whose per-layer leaves
    carry a leading layer axis: one more than the port's for a layer's
    parameter (a ``(d,)`` norm is 2-D there)."""
    return p.dim() + name.startswith("layers.")


def _vocab(model):
    """(the group the embedding's rows are split over or None, the first
    row this rank holds)."""
    mg = getattr(model, "vocab_mg", None)
    return mg, (mg.rank * model.embed.shape[0] if mg is not None else 0)


def _lookup(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the embedding as bf16 activations; vocab
    parallel, each rank's own rows (zero elsewhere) summed over the
    group."""
    mg, v0 = _vocab(model)
    embed = fsdp.leaf(model, "embed")
    if mg is None:
        return embed_lookup(embed, tokens)
    vl = embed.shape[0]
    ids = tokens.long() - v0
    mine = (ids >= 0) & (ids < vl)
    rows = embed_lookup(embed, ids.clamp(0, vl - 1))
    return tpar.reduce_from(torch.where(mine[..., None], rows,
                                        rows.new_zeros(())), mg)


def _head(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """The tied head: ``x (..., D)`` -> logits ``(..., V)`` bf16, this
    rank's columns where the vocabulary is split."""
    mg, _ = _vocab(model)
    return tpar.copy_to(x, mg) @ fsdp.leaf(model, "embed").to(BF16).t()


def _gathered(model: Transformer, logits: torch.Tensor) -> torch.Tensor:
    return tpar.gather(logits, -1, _vocab(model)[0])


def _input_embeds(model: Transformer, batch, cfg) -> torch.Tensor:
    if cfg.embed_stub and "frames" in batch:
        return batch["frames"].to(BF16)
    return _lookup(model, batch["tokens"])


def _rope(positions: torch.Tensor, cfg):
    """The RoPE tables of a forward's positions (none for an arch without
    attention heads)."""
    if not cfg.num_heads:
        return None
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


# ---- training -----------------------------------------------------------------

def _remat(fn, policy: Optional[str]):
    if policy is None:
        return fn
    pol = REMAT_POLICIES[policy]
    if pol is None:
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     pol))


def _run_unit(units, cfg, tables, img, x):
    """One remat unit's layers in order -> (x, their MoE aux loss or
    None)."""
    aux = None
    for layer in units:
        x, a = blocks.apply_layer_train(layer.kind, layer, x, cfg, tables,
                                        img)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward_train(model: Transformer, batch, cfg,
                  remat_policy: Optional[str] = "full"):
    """``batch``: ``tokens`` (or ``frames`` for an ``embed_stub`` arch; plus
    ``image_embeds`` for ``xattn`` layers) -> (logits ``(B, S, V)`` bf16,
    this rank's columns where the vocabulary is split; the summed MoE aux
    loss, an f32 scalar).  Each repetition of a
    segment's pattern runs under ``remat_policy``."""
    x = _input_embeds(model, batch, cfg)
    img = batch.get("image_embeds")
    if img is not None:
        img = img.to(BF16)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    tables = _rope(positions, cfg)
    aux, k = None, 0
    for pattern, n in blocks.plan_segments(cfg):
        for _ in range(n):
            unit = model.layers[k:k + len(pattern)]
            k += len(pattern)
            x, a = _remat(functools.partial(_run_unit, unit, cfg, tables,
                                            img), remat_policy)(x)
            if a is not None:
                aux = a if aux is None else aux + a
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _head(model, x)
    if aux is None:
        aux = torch.zeros((), dtype=F32, device=x.device)
    return logits, aux


def loss_fn(model: Transformer, batch, cfg,
            remat_policy: Optional[str] = "full") -> torch.Tensor:
    """Mean next-token cross-entropy in f32 (plus the MoE aux loss times
    its weight): the reference's max-shifted log-sum-exp, with the target
    logit read by ``gather`` where the reference multiplies by a one-hot
    (the same number, without a ``(B, S, V)`` f32 one-hot)."""
    logits, aux = forward_train(model, batch, cfg, remat_policy)
    logits = logits.to(F32)
    labels = batch["labels"].long()
    mg, v0 = _vocab(model)
    if mg is None:
        m = logits.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        tgt = logits.gather(-1, labels[..., None])[..., 0]
    else:       # vocab parallel: three reductions over the group
        m = tpar.reduce_from(logits.detach().amax(dim=-1, keepdim=True), mg,
                             torch.distributed.ReduceOp.MAX)
        total = tpar.reduce_from(torch.exp(logits - m).sum(dim=-1), mg)
        lse = torch.log(total) + m[..., 0]
        vl = logits.shape[-1]
        ids = labels - v0
        mine = (ids >= 0) & (ids < vl)
        own = logits.gather(-1, ids.clamp(0, vl - 1)[..., None])[..., 0]
        tgt = tpar.reduce_from(torch.where(mine, own, own.new_zeros(())), mg)
    nll = (lse - tgt).mean()
    if cfg.moe is not None:
        nll = nll + cfg.moe.aux_loss_weight * aux
    return nll


# ---- serving ------------------------------------------------------------------

def init_caches(cfg, batch: int, max_seq: int, device=None, *,
                tp: int = 1) -> Caches:
    """Zeroed caches, one dict per layer, on ``device`` (default CUDA;
    ``"meta"`` for shapes alone); at ``tp > 1`` the pieces one rank of the
    model group holds (``sharding.cache_pspec``)."""
    dev = device if str(device) == "meta" else resolve_device(device)
    spec = attn.cache_spec(cfg, max_seq)
    return [blocks.init_layer_cache(kind, cfg, spec, batch, dev, tp)
            for kind in blocks.layer_kinds(cfg)]


def forward_prefill(model: Transformer, batch, cfg, max_seq: int):
    """Prompt ``{"tokens": (B, S)}`` (or ``{"frames": (B, S, D)}`` for an
    ``embed_stub`` arch; ``"image_embeds": (B, N, D)`` for ``xattn``
    layers) -> (last-token logits ``(B, V)`` bf16, caches: this rank's
    pieces on a sharded model)."""
    x = _input_embeds(model, batch, cfg)
    img = batch.get("image_embeds")
    if img is not None:
        img = img.to(BF16)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    tables = _rope(positions, cfg)
    spec = attn.cache_spec(cfg, max_seq)
    caches = []
    for layer in model.layers:
        x, c = blocks.apply_layer_prefill(layer.kind, layer, x, positions,
                                          cfg, spec, tables, img)
        caches.append(c)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return _gathered(model, _head(model, x[:, -1])), caches


def forward_decode(model: Transformer, batch, caches: Caches, cfg,
                   max_seq: int):
    """One-token step: ``{"token": (B,), "pos": (B,)}`` -> (logits ``(B,
    V)`` bf16, caches updated in place)."""
    pos = batch["pos"]
    x = _lookup(model, batch["token"][:, None])
    tables = _rope(pos[:, None], cfg)
    spec = attn.cache_spec(cfg, max_seq)
    for layer, cache in zip(model.layers, caches):
        x, _ = blocks.apply_layer_decode(layer.kind, layer, x, pos, cache,
                                         spec, cfg, tables)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _head(model, x[:, 0])
    return _gathered(model, logits), caches
