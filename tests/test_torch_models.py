"""The port's model stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's, on the CPU.

Weights are the JAX package's ``init_params`` draws carried over with
``params_from_jax``; inputs come from numpy seeds.  Every result (logits,
K/V caches, each op) is compared in f32 two ways:

* **op by op** at ``TOL``: the reference run under ``jax.disable_jit()``
  executes the same sequence of bf16/f32 primitives as the port; they
  differ only where a transcendental (``exp``, ``tanh``, the logistic)
  is implemented differently, by an ulp before the bf16 cast;
* **compiled** as the reference's own tests run it (``lax.scan`` compiles
  each segment's body, and XLA fuses elementwise chains, rounding some
  bf16 intermediates differently): single ops at ``TOL``, the whole
  model's logits and caches at ``COMPILED_TOL``, the reference's own
  prefill-against-train tolerance.  The reference's compiled and op-by-op
  runs differ from each other by up to 0.0254 on phi4-mini's reduced
  logits, past ``TOL`` near zero (CHANGES.md gives the measured errors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import forward_decode as jdecode
from repro.models import forward_prefill as jprefill
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro_torch import configs
from repro_torch.models import (attention, forward_decode, forward_prefill,
                                init_caches, init_params, layers, mlp,
                                params_from_jax)
from repro_torch.models import blocks
from repro_torch.models.blocks import plan_segments

TOL = 2e-2
COMPILED_TOL = 5e-2
DENSE = ["phi4-mini-3.8b", "starcoder2-7b", "nemotron-4-15b", "granite-20b"]
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
    """The JAX package's stacked caches as one ``{k, v}`` per layer in
    execution order."""
    out = []
    for si, (pattern, n) in enumerate(plan_segments(cfg)):
        for j in range(n):
            for i, _ in enumerate(pattern):
                c = caches[f"seg{si}"][f"sub{i}"]
                out.append({"k": np.asarray(c["k"])[j],
                            "v": np.asarray(c["v"])[j]})
    return out


# ---- configs -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_configs_equal_the_reference(name):
    mine, ref = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    assert mine.pattern_layers == ref.pattern_layers
    assert dataclasses.asdict(configs.reduced_config(name)) == \
        dataclasses.asdict(jconfigs.reduced_config(name))


def test_registry_sets_and_the_served_width():
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    assert configs.FSDP_ARCHS == jconfigs.FSDP_ARCHS
    assert configs.BF16_STATE_ARCHS == jconfigs.BF16_STATE_ARCHS
    phi4 = configs.get_config("phi4-mini-3.8b")
    assert (phi4.num_layers, phi4.d_model, phi4.num_heads, phi4.num_kv_heads,
            phi4.head_dim, phi4.d_ff, phi4.vocab_size) == \
        (32, 3072, 24, 8, 128, 8192, 200064)
    assert phi4.param_count() == 3_836_018_688
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


# ---- ops -----------------------------------------------------------------------

def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32) * 2
    s = rng.normal(size=(64,)).astype(np.float32) * 0.1
    want = jlayers.rms_norm(jbf(x), jnp.asarray(s))
    got = layers.rms_norm(tbf(x), torch.from_numpy(s))
    close(got, want, "rms_norm")
    close(got, jax.jit(jlayers.rms_norm)(jbf(x), jnp.asarray(s)),
          "rms_norm compiled")
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = (np.arange(6, dtype=np.int32)[None] + np.array([[0], [37]])) \
        .astype(np.int32)
    want = jlayers.apply_rope(jbf(q), jnp.asarray(pos), 10000.0)
    got = layers.apply_rope(tbf(q), layers.rope_tables(
        torch.from_numpy(pos), 16, 10000.0))
    close(got, want, "apply_rope")
    close(got, jax.jit(jlayers.apply_rope, static_argnums=2)(
        jbf(q), jnp.asarray(pos), 10000.0), "apply_rope compiled")
    assert np.array_equal(layers.causal_mask(5, 9, 3, 4).numpy(),
                          np.asarray(jlayers.causal_mask(5, 9, 3, 4)))


@pytest.mark.parametrize("kind", mlp.KINDS)
def test_mlp_kinds(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {"w_in": rng.normal(size=(64, 128)) / 8,
         "w_gate": rng.normal(size=(64, 128)) / 8,
         "w_out": rng.normal(size=(128, 64)) / 11}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    m = mlp.MLP(64, 128, kind, device="cpu")
    for name in ("w_in", "w_out", "w_gate"):
        if getattr(m, name) is not None:
            getattr(m, name).copy_(torch.from_numpy(p[name].astype(np.float32)))
    got = m(tbf(x))
    close(got, jmlp.mlp_apply(jp, jbf(x), kind), kind)
    close(got, jax.jit(jmlp.mlp_apply, static_argnums=2)(jp, jbf(x), kind),
          f"{kind} compiled")


@pytest.mark.parametrize("window,causal,q_offset", [
    (None, True, 0), (4, True, 0), (None, False, 0), (None, True, 3)])
def test_full_attention(window, causal, q_offset):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    kw = dict(q_offset=q_offset, window=window, causal=causal)
    got = attention.full_attention(tbf(q), tbf(k), tbf(v), **kw)
    close(got, jattn.full_attention(jbf(q), jbf(k), jbf(v), **kw),
          "full_attention")
    close(got, jax.jit(lambda a, b, c: jattn.full_attention(a, b, c, **kw))(
        jbf(q), jbf(k), jbf(v)), "full_attention compiled")


def test_chunked_attention_equals_full():
    rng = np.random.default_rng(3)
    q, k, v = (tbf(rng.normal(size=(1, 16, 4, 16))) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    got = attention.chunked_attention(q, k, v, chunk=4, window=6)
    assert torch.equal(got, attention.full_attention(q, k, v, window=6))
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)]
    close(got, jattn.chunked_attention(*j, chunk=4, window=6), "chunked")


@pytest.mark.parametrize("window,max_seq", [(None, 16), (8, 16)])
def test_attention_decode(window, max_seq):
    """One decode step into a half-filled (and, windowed, wrapped) cache,
    held against the reference's functional update."""
    base = configs.reduced_config("phi4-mini-3.8b")
    cfg = dataclasses.replace(base, window=window)
    jcfg = dataclasses.replace(jconfigs.reduced_config("phi4-mini-3.8b"),
                               window=window)
    rng = np.random.default_rng(4)
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": rng.normal(size=(d, h, hd)) / 8,
         "wk": rng.normal(size=(d, kh, hd)) / 8,
         "wv": rng.normal(size=(d, kh, hd)) / 8,
         "wo": rng.normal(size=(h, hd, d)) / 8}
    mod = attention.Attention(cfg, device="cpu")
    for name, arr in p.items():
        getattr(mod, name).copy_(torch.from_numpy(arr.astype(np.float32)))
    spec = attention.cache_spec(cfg, max_seq)
    jspec = jattn.cache_spec(jcfg, max_seq)
    assert (spec.length, spec.ring) == (jspec.length, jspec.ring)
    shape = (3, spec.length, kh, hd)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(3, 1, d)).astype(np.float32)
    pos = np.array([0, 5, 13], np.int32)
    jy, jc = jattn.attention_decode(
        {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}, jbf(x),
        jnp.asarray(pos), {"k": jbf(ck), "v": jbf(cv)}, jspec, jcfg, 1)
    cache = {"k": tbf(ck), "v": tbf(cv)}
    tpos = torch.from_numpy(pos)
    y, c = attention.attention_decode(
        mod, tbf(x), tpos, cache, spec, cfg,
        layers.rope_tables(tpos[:, None], hd, cfg.rope_theta))
    assert c is cache                     # written in place
    close(y, jy, "decode out")
    close(c["k"], jc["k"], "decode k")
    close(c["v"], jc["v"], "decode v")


# ---- the model -----------------------------------------------------------------

CASES = [(name, None, 6) for name in DENSE] + [("phi4-mini-3.8b", 8, 12)]


def _configs(name, window):
    cfg, jcfg = configs.reduced_config(name), jconfigs.reduced_config(name)
    if window is not None:
        cfg = dataclasses.replace(cfg, window=window)
        jcfg = dataclasses.replace(jcfg, window=window)
    return cfg, jcfg


def _run_both(name, window, plen, *, op_by_op):
    """Prefill, then four teacher-forced decode steps, in the port and the
    reference; returns both lists of (logits, per-layer caches)."""
    cfg, jcfg = _configs(name, window)
    jp = jinit(jax.random.key(1), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                            device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32)

    def reference(prefill, decode):
        lg, caches = prefill(jp, {"tokens": jnp.asarray(toks)})
        out = [(lg, jax_layer_caches(caches, jcfg))]
        for i, tok in enumerate(steps):
            pos = jnp.full((2,), plen + i, jnp.int32)
            lg, caches = decode(jp, {"token": jnp.asarray(tok), "pos": pos},
                                caches)
            out.append((lg, jax_layer_caches(caches, jcfg)))
        return out

    def prefill(p, b):
        return jprefill(p, b, jcfg, max_seq=MAX_SEQ)

    def decode(p, b, c):
        return jdecode(p, b, c, jcfg, max_seq=MAX_SEQ)

    if op_by_op:
        with jax.disable_jit():
            want = reference(prefill, decode)
    else:
        want = reference(jax.jit(prefill), jax.jit(decode))

    with torch.inference_mode():
        lg, caches = forward_prefill(model, {"tokens": torch.from_numpy(toks)},
                                     cfg, MAX_SEQ)
        got = [(lg, [{k: c[k].clone() for k in c} for c in caches])]
        for i, tok in enumerate(steps):
            pos = torch.full((2,), plen + i, dtype=torch.int32)
            lg, caches = forward_decode(model, {"token": torch.from_numpy(tok),
                                                "pos": pos}, caches, cfg,
                                        MAX_SEQ)
            got.append((lg, [{k: c[k].clone() for k in c} for c in caches]))
    assert len(got[0][1]) == cfg.num_layers
    return got, want


def _hold(got, want, tol, how):
    for step, ((lg, cs), (wlg, wcs)) in enumerate(zip(got, want)):
        close(lg, wlg, f"logits step {step} {how}", tol)
        for layer, (c, wc) in enumerate(zip(cs, wcs)):
            for kv in ("k", "v"):
                close(c[kv], wc[kv], f"{kv} layer {layer} step {step} {how}",
                      tol)


@pytest.mark.parametrize("name,window,plen", CASES,
                         ids=[f"{n}-w{w}" for n, w, _ in CASES])
def test_prefill_and_decode_match_the_reference(name, window, plen):
    """Prefill's last-token logits and K/V caches, then four teacher-forced
    decode steps (with ``window=8`` the ring wraps), against the compiled
    reference at ``COMPILED_TOL``."""
    got, want = _run_both(name, window, plen, op_by_op=False)
    _hold(got, want, COMPILED_TOL, "compiled")


def test_windowed_model_matches_the_reference_op_by_op():
    """The windowed case (the ring wraps) against the reference run op by
    op, at ``TOL``."""
    got, want = _run_both("phi4-mini-3.8b", 8, 12, op_by_op=True)
    _hold(got, want, TOL, "op by op")


def test_init_params_draws_the_reference_scales():
    cfg = configs.reduced_config("phi4-mini-3.8b")
    model = init_params(cfg, 7, device="cpu")
    again = init_params(cfg, 7, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    assert model.embed.dtype == torch.bfloat16
    assert model.final_norm.dtype == torch.float32
    assert float(model.embed.float().std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.05)
    blk = model.layers[0]
    assert float(blk.attn.wo.float().std()) == pytest.approx(
        (cfg.num_heads * cfg.head_dim) ** -0.5, rel=0.1)
    assert float(blk.mlp.w_out.float().std()) == pytest.approx(
        cfg.d_ff ** -0.5, rel=0.1)
    assert not blk.norm1.any() and not blk.norm2.any()
    caches = init_caches(cfg, 3, 20, device="cpu")
    assert len(caches) == cfg.num_layers
    assert caches[0]["k"].shape == (3, 20, cfg.num_kv_heads, cfg.head_dim)


def test_audio_frames_and_bad_shapes_raise():
    """musicgen's code ids prefill as tokens (its frames:
    tests/test_torch_xattn_audio.py), and a carried leaf of the wrong shape
    raises."""
    cfg = configs.reduced_config("musicgen-large")
    model = init_params(cfg, device="cpu")
    lg, _ = forward_prefill(model, {"tokens": torch.ones(1, 3,
                                                         dtype=torch.int32)},
                            cfg, 16)
    assert lg.shape == (1, cfg.vocab_size)
    phi4 = configs.reduced_config("phi4-mini-3.8b")
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(0), phi4))
    tree["embed"] = tree["embed"][:, :32]
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(tree, phi4, device="cpu")


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_every_arch_builds_and_carries_over(name):
    """Every arch's reduced config builds with ``init_params`` and takes the
    JAX package's draw through ``params_from_jax``, leaf for leaf."""
    cfg, jcfg = configs.reduced_config(name), jconfigs.reduced_config(name)
    model = init_params(cfg, device="cpu")
    assert [b.kind for b in model.layers] == list(
        blocks.layer_kinds(cfg))
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(2), jcfg))
    carried = params_from_jax(tree, cfg, device="cpu")
    assert torch.equal(carried.embed, torch.from_numpy(
        np.asarray(tree["embed"])).to(torch.bfloat16))
    want = sum(np.asarray(leaf).size
               for leaf in jax.tree_util.tree_leaves(tree))
    assert sum(p.numel() for p in carried.parameters()) == want


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.reduced_config("phi4-mini-3.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_caches(cfg, 2, 8)
