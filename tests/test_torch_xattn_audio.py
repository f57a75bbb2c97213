"""The port's cross-attention and frame inputs against the JAX package's, on
the CPU: ``cross_attention``, the ``xattn`` layer's prefill (its cache is
the image K/V) and decode, a served VLM's decode against the zero image
cache ``init_caches`` gives it (the engine never prefills one), and the
reduced llama-3.2-vision-11b with ``image_embeds`` and musicgen-large with
``frames`` (tests/torch_models_ref.py).

Ops and layers are held at ``TOL`` against the reference run op by op and
compiled.  The reduced VLM's whole model is held to the reference run op
by op at ``COMPILED_TOL``, not ``TOL``: one bf16 product in its layer 1's
MLP rounds to the other neighbour of its f32 sum in the reference
(reduction order), and 10 layers of random reduced weights carry that one
ulp (0.0078) to 0.049 in the last caches and logits (measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_models_ref as R
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import forward_decode as jdecode
from repro.models import init_caches as jinit_caches
from repro_torch.models import (attention, blocks, forward_decode,
                                forward_prefill, init_caches, init_params)
from repro_torch.models.layers import rope_tables

VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-large"


@pytest.fixture(scope="module")
def vlm():
    cfg, jcfg = R.configs_of(VLM)
    jp, model = R.models_of(cfg, jcfg)
    return cfg, jcfg, jp, model


def _xattn_params(jp, model, cfg):
    """The first xattn layer's params in both packages."""
    layer = blocks.layer_kinds(cfg).index("xattn")
    sub = cfg.layer_pattern.index("xattn")
    p = jax.tree_util.tree_map(lambda a: a[0], jp["seg0"][f"sub{sub}"])
    return p, model.layers[layer]


def _pair(fn_ref):
    with jax.disable_jit():
        eager = fn_ref()
    return eager, jax.jit(fn_ref)()


def test_cross_attention(vlm):
    cfg, jcfg, jp, model = vlm
    p, blk = _xattn_params(jp, model, cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    img = rng.normal(size=(2, cfg.num_image_tokens, cfg.d_model)) \
        .astype(np.float32)
    got = attention.cross_attention(blk.xattn, R.tbf(x), R.tbf(img))
    for how, want in zip(("op by op", "compiled"), _pair(
            lambda: jattn.cross_attention(p["xattn"], R.jbf(x), R.jbf(img),
                                          jcfg, 1))):
        R.close(got, want, f"cross_attention {how}")


def test_xattn_layer_prefill_and_decode(vlm):
    """The layer's prefill (residual, MLP, and the image K/V as its cache)
    and its decode over that cache, which the decode leaves as it was."""
    cfg, jcfg, jp, model = vlm
    p, blk = _xattn_params(jp, model, cfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    img = rng.normal(size=(2, cfg.num_image_tokens, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    spec, jspec = (attention.cache_spec(cfg, R.MAX_SEQ),
                   jattn.cache_spec(jcfg, R.MAX_SEQ))
    tpos = torch.from_numpy(pos.copy())
    with torch.inference_mode():
        y, cache = blocks.apply_layer_prefill(
            "xattn", blk, R.tbf(x), tpos, cfg, spec,
            rope_tables(tpos, cfg.head_dim, cfg.rope_theta), R.tbf(img))
        k0 = cache["k"].clone()
        y1, cache1 = blocks.apply_layer_decode(
            "xattn", blk, R.tbf(x1), torch.full((2,), 6, dtype=torch.int32),
            cache, spec, cfg, None)
    assert cache1 is cache and torch.equal(cache["k"], k0)
    assert cache["k"].shape == (2, cfg.num_image_tokens, cfg.num_kv_heads,
                                cfg.head_dim)

    def ref():
        yy, c = jblocks.apply_layer_prefill(
            "xattn", p, R.jbf(x), jnp.asarray(pos), jcfg, 1, jspec,
            R.jbf(img))
        yy1, _ = jblocks.apply_layer_decode(
            "xattn", p, R.jbf(x1), jnp.full((2,), 6, jnp.int32), c, jspec,
            jcfg, 1)
        return yy, c, yy1

    for how, (wy, wc, wy1) in zip(("op by op", "compiled"), _pair(ref)):
        R.close(y, wy, f"xattn prefill {how}")
        R.close(cache["k"], wc["k"], f"xattn image k {how}")
        R.close(cache["v"], wc["v"], f"xattn image v {how}")
        R.close(y1, wy1, f"xattn decode {how}")


def test_served_vlm_decodes_against_the_zero_image_cache(vlm):
    """The engine never prefills a VLM's image cache: two decode steps from
    ``init_caches`` (image K/V zero) in both packages."""
    cfg, jcfg, jp, model = vlm
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    caches = init_caches(cfg, 3, R.MAX_SEQ, device="cpu")
    xk = caches[blocks.layer_kinds(cfg).index("xattn")]["k"]
    assert xk.shape == (3, cfg.num_image_tokens, cfg.num_kv_heads,
                        cfg.head_dim) and not xk.any()
    got = []
    with torch.inference_mode():
        for i, tok in enumerate(toks):
            lg, caches = forward_decode(
                model, {"token": torch.from_numpy(tok),
                        "pos": torch.full((3,), i, dtype=torch.int32)},
                caches, cfg, R.MAX_SEQ)
            got.append(lg)

    def ref():
        c = jinit_caches(jcfg, 3, R.MAX_SEQ)
        out = []
        for i, tok in enumerate(toks):
            lg, c = jdecode(jp, {"token": jnp.asarray(tok),
                                 "pos": jnp.full((3,), i, jnp.int32)}, c,
                            jcfg, max_seq=R.MAX_SEQ)
            out.append(lg)
        return out

    with jax.disable_jit():
        want = ref()
    for i, (a, b) in enumerate(zip(got, want)):
        R.close(a, b, f"zero-image decode step {i} op by op")


@pytest.fixture(scope="module", params=[VLM, AUDIO])
def reduced_runs(request):
    cfg, jcfg = R.configs_of(request.param)
    jp, model = R.models_of(cfg, jcfg)
    inp, toks = R.inputs_of(cfg, 6)
    assert ("image_embeds" in inp) == (request.param == VLM)
    assert ("frames" in inp) == (request.param == AUDIO)
    return (request.param, R.run_port(model, cfg, inp, toks),
            R.run_reference(jp, jcfg, inp, toks, op_by_op=False),
            R.run_reference(jp, jcfg, inp, toks, op_by_op=True))


@pytest.mark.parametrize("how", ["compiled", "op_by_op"])
def test_reduced_model_matches_the_reference(reduced_runs, how):
    """The VLM's prefill with ``image_embeds`` (its xattn caches are the
    image K/V), musicgen's with ``frames``, then four teacher-forced decode
    steps of code ids or tokens: against the compiled reference at
    ``COMPILED_TOL`` beyond its own spread, and the reference run op by op
    (the VLM at ``COMPILED_TOL``, the module docstring says why)."""
    name, got, compiled, op_by_op = reduced_runs
    if how == "compiled":
        R.hold_compiled(got, compiled, op_by_op)
    else:
        R.hold(got, op_by_op, R.COMPILED_TOL if name == VLM else R.TOL,
               "op by op")


def test_frames_and_image_embeds_are_the_inputs():
    """musicgen's prefill reads ``frames`` in place of the token embedding
    (the embedding's rows as frames give the tokens' logits); a VLM's
    prefill needs ``image_embeds``."""
    cfg, _ = R.configs_of(AUDIO)
    model = init_params(cfg, 3, device="cpu")
    toks = torch.tensor([[5, 9, 200, 7]], dtype=torch.int32)
    with torch.inference_mode():
        by_frames, _ = forward_prefill(
            model, {"frames": model.embed[toks].float()}, cfg, 16)
        by_tokens, _ = forward_prefill(model, {"tokens": toks}, cfg, 16)
        other, _ = forward_prefill(
            model, {"frames": model.embed[toks + 1].float()}, cfg, 16)
    assert by_frames.shape == (1, cfg.vocab_size)
    assert torch.equal(by_frames, by_tokens)
    assert not torch.equal(by_frames, other)
    vcfg, _ = R.configs_of(VLM)
    vlm_model = init_params(vcfg, 3, device="cpu")
    with pytest.raises(ValueError, match="image_embeds"):
        forward_prefill(vlm_model, {"tokens": torch.ones((1, 3),
                                                         dtype=torch.int32)},
                        vcfg, 16)
