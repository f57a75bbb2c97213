"""Helpers shared by the port's model parity tests on the CPU
(test_torch_moe, test_torch_recurrent, test_torch_xattn_audio): a reduced
arch built in both packages from the JAX package's ``init_params`` draw,
run through prefill and teacher-forced decode steps, and held together.

Imports jax; not collected by pytest.  Tolerances are
tests/test_torch_models.py's: ``TOL`` against the reference run op by op
(``jax.disable_jit()``: the same sequence of bf16/f32 primitives as the
port), ``COMPILED_TOL`` against the compiled reference.  XLA's fused
programs keep some bf16 intermediates in f32, so the compiled reference
differs from its own op-by-op run; on two reduced archs by more than
``COMPILED_TOL`` (recurrentgemma-2b's logits by 0.084, the VLM's K cache
by 0.065).  :func:`hold_compiled` therefore holds the port to the compiled
run at ``COMPILED_TOL`` beyond the reference's own spread at each element.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import forward_decode as jdecode
from repro.models import forward_prefill as jprefill
from repro.models import init_params as jinit
from repro_torch import configs
from repro_torch.models import forward_decode, forward_prefill, params_from_jax
from repro_torch.models.blocks import plan_segments

TOL = 2e-2
COMPILED_TOL = 5e-2
MAX_SEQ = 32


def f32(x) -> np.ndarray:
    """A JAX array or torch tensor (bf16 or not) as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def close(got, want, what, tol=TOL):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def jbf(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def tbf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def jax_layer_caches(caches, cfg):
    """The JAX package's stacked caches as one dict per layer in execution
    order (numpy leaves)."""
    out = []
    for si, (pattern, n) in enumerate(plan_segments(cfg)):
        for j in range(n):
            for i, _ in enumerate(pattern):
                c = caches[f"seg{si}"][f"sub{i}"]
                out.append({k: np.asarray(v)[j] for k, v in c.items()})
    return out


def configs_of(name, **changes):
    """The reduced config of ``name`` in both packages, with ``changes``."""
    cfg = dataclasses.replace(configs.reduced_config(name), **changes)
    jcfg = dataclasses.replace(jconfigs.reduced_config(name), **changes)
    return cfg, jcfg


def models_of(cfg, jcfg, seed=1):
    """The JAX package's ``init_params(key(seed))`` draw and the port's
    model carried over from it."""
    jp = jinit(jax.random.key(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               device="cpu")


def inputs_of(cfg, plen, steps=4, batch=2, seed=5):
    """Numpy prefill inputs (``tokens``, or ``frames`` for an embed-stub
    arch, plus ``image_embeds`` for an ``xattn`` arch) and ``steps``
    teacher-forced decode tokens."""
    rng = np.random.default_rng(seed)
    inp = {}
    if cfg.embed_stub:
        inp["frames"] = rng.normal(size=(batch, plen, cfg.d_model)) \
            .astype(np.float32)
    else:
        inp["tokens"] = rng.integers(0, cfg.vocab_size, (batch, plen)) \
            .astype(np.int32)
    if "xattn" in cfg.layer_pattern:
        inp["image_embeds"] = rng.normal(
            size=(batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (steps, batch)).astype(np.int32)
    return inp, toks


def run_reference(jp, jcfg, inp, toks, *, op_by_op):
    """The JAX package's prefill, then one decode step per row of
    ``toks``: a list of (logits, per-layer caches)."""
    def prefill(p, b):
        return jprefill(p, b, jcfg, max_seq=MAX_SEQ)

    def decode(p, b, c):
        return jdecode(p, b, c, jcfg, max_seq=MAX_SEQ)

    def run(prefill, decode):
        plen = next(iter(inp.values())).shape[1]
        batch = {k: (jbf(v) if v.dtype == np.float32 else jnp.asarray(v))
                 for k, v in inp.items()}
        lg, caches = prefill(jp, batch)
        out = [(lg, jax_layer_caches(caches, jcfg))]
        for i, tok in enumerate(toks):
            pos = jnp.full((len(tok),), plen + i, jnp.int32)
            lg, caches = decode(jp, {"token": jnp.asarray(tok), "pos": pos},
                                caches)
            out.append((lg, jax_layer_caches(caches, jcfg)))
        return out

    if op_by_op:
        with jax.disable_jit():
            return run(prefill, decode)
    return run(jax.jit(prefill), jax.jit(decode))


def run_port(model, cfg, inp, toks):
    """The port's prefill and decode steps on the same inputs."""
    plen = next(iter(inp.values())).shape[1]
    batch = {k: (tbf(v) if v.dtype == np.float32 else torch.from_numpy(v))
             for k, v in inp.items()}
    with torch.inference_mode():
        lg, caches = forward_prefill(model, batch, cfg, MAX_SEQ)
        out = [(lg, [{k: c[k].clone() for k in c} for c in caches])]
        for i, tok in enumerate(toks):
            pos = torch.full((len(tok),), plen + i, dtype=torch.int32)
            lg, caches = forward_decode(model, {"token": torch.from_numpy(tok),
                                                "pos": pos}, caches, cfg,
                                        MAX_SEQ)
            out.append((lg, [{k: c[k].clone() for k in c} for c in caches]))
    assert len(out[0][1]) == cfg.num_layers
    return out


def hold(got, want, tol, how):
    """Every step's logits and every layer's cache leaves within ``tol``."""
    assert len(got) == len(want)
    for step, ((lg, cs), (wlg, wcs)) in enumerate(zip(got, want)):
        close(lg, wlg, f"logits step {step} {how}", tol)
        for layer, (c, wc) in enumerate(zip(cs, wcs)):
            assert sorted(c) == sorted(wc), (layer, sorted(c), sorted(wc))
            for k in c:
                close(c[k], wc[k], f"{k} layer {layer} step {step} {how}",
                      tol)


def _pairs(a, b):
    if isinstance(a, dict):          # leaves by name (the training tests)
        for k in a:
            yield k, a[k], b[k]
        return
    for (lg, cs), (wlg, wcs) in zip(a, b):
        yield "logits", lg, wlg
        for c, wc in zip(cs, wcs):
            for k in c:
                yield k, c[k], wc[k]


def hold_compiled(got, compiled, op_by_op, how="compiled"):
    """The port against the compiled reference: at each element, ``|port
    - compiled| <= |op_by_op - compiled| + COMPILED_TOL * (1 +
    |compiled|)``, where ``op_by_op`` is the reference's own run op by op.
    The runs are lists of (logits, per-layer caches), or dicts of leaves
    by name.  Returns the largest spread of the reference's two runs."""
    assert len(got) == len(compiled) == len(op_by_op)
    spread = 0.0
    for i, ((what, x, c), (_, e, _)) in enumerate(
            zip(_pairs(got, compiled), _pairs(op_by_op, compiled))):
        x, c, e = f32(x), f32(c), f32(e)
        assert x.shape == c.shape, (what, x.shape, c.shape)
        own = np.abs(e - c)
        spread = max(spread, float(own.max()))
        bad = np.abs(x - c) > own + COMPILED_TOL * (1 + np.abs(c))
        assert not bad.any(), (f"{what} #{i} {how}", x[bad][:5], c[bad][:5],
                               e[bad][:5])
    return spread
