"""Helpers shared by the port's training parity tests on the CPU
(test_torch_train, test_torch_train_kinds, test_torch_checkpoint): both
packages' models from one ``init_params`` draw of the JAX package, fixed
batches from numpy or ``jax.random`` seeds, and the reference's stacked
leaves read at a port parameter's name.

Imports jax; not collected by pytest.

Tolerances, each measured on the reduced configs before it was set:

* ``LOSS_RTOL`` (5e-4): the port's loss against the reference run op by op
  (the same bf16/f32 sequence; measured up to 9e-5 relative, the VLM);
* ``GRAD_TOL`` (5e-2 of the leaf's largest magnitude): the port's f32
  gradients against the op-by-op reference's (measured up to 0.024: bf16
  products in the backward pass round differently);
* ``TRAIN_RTOL`` (2e-3) and ``PARAM_ATOL`` (1e-2, ten steps of the
  ``1e-3`` learning rate): the port's training steps against the compiled
  reference's; losses there differ by up to 2.3e-4 relative after 4 steps,
  and Adam's first updates are near ``lr * sign(g)``, so an element whose
  gradient is near 0 may step the other way (params measured 4.7e-3
  apart after 4 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit
from repro_torch import configs
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import reference_paths

LOSS_RTOL = 5e-4
GRAD_TOL = 5e-2
TRAIN_RTOL = 2e-3
PARAM_ATOL = 1e-2
F32 = torch.float32


def flat(tree, prefix=""):
    """A nested dict's leaves as numpy arrays under dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def at(leaves, path, j):
    """The reference leaf at ``path``, layer ``j`` of its stacked axis."""
    return leaves[path] if j is None else leaves[path][j]


def models_of(name, seed=0):
    """(port config, reference config, the reference's params, the port's
    f32 model carried over from them) for the reduced ``name``."""
    cfg, jcfg = configs.reduced_config(name), jconfigs.reduced_config(name)
    jp = jinit(jax.random.key(seed), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                            device="cpu", dtype=F32)
    return cfg, jcfg, jp, model


def fixed_batch(cfg, b=4, s=32):
    """``tests/test_train.py``'s fixed batch: tokens from
    ``jax.random.key(7)``, as numpy."""
    toks = np.asarray(jax.random.randint(jax.random.key(7), (b, s + 1), 0,
                                         cfg.vocab_size))
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def kind_batch(cfg, b=2, s=8, seed=5):
    """A numpy batch for any kind: tokens or frames, labels, and image
    embeddings for an ``xattn`` arch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.embed_stub:
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    if cfg.num_image_tokens:
        out["image_embeds"] = rng.normal(
            size=(b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def port_params_as_reference(model, tree):
    """Each port parameter beside the reference leaf it stands for:
    ``{name: (port numpy, reference numpy)}``; ``tree`` is the
    reference's params pytree."""
    leaves = flat(jax.tree_util.tree_map(np.asarray, tree))
    return {n: (p.detach().numpy(), at(leaves, *reference_paths(model)[n]))
            for n, p in model.named_parameters()}
