"""The port's recurrent kinds (``repro_torch.models.rglru``, ``.mamba``) and
the reduced recurrentgemma-2b and falcon-mamba-7b against the JAX
package's, on the CPU; and the reference engine's recurrent-state fault,
carried over.

The layers' bf16 outputs are held at ``TOL`` against the reference run op
by op and compiled.  Their f32 states are held to the reference run op by
op at ``STATE_TOL``, relative and absolute: on the CPU the port scans each
chunk with ``repro::linear_scan``'s plain version, the reference's
associative scan in torch ops (on the card the kernel steps it in order),
so a state differs by f32 rounding at most (512 steps included).  The compiled
reference keeps the bf16 outputs of mamba's ``x_proj``/``dt_proj``
products in f32 (XLA's excess precision), which moves its states by up to
2e-4 relative, so against it the states are held at ``TOL``.  A prefill of
512 tokens runs two of the reference's 256-token chunks.

The reference's ``ServeEngine`` prefills a prompt by full-batch decode
steps and never resets a freed slot's state, so a recurrent request's
tokens depend on its neighbours (ROADMAP, Carried notes).  The port keeps
that engine; ``test_engine_carries_the_recurrent_state_fault`` pins it
token for token against the JAX engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_models_ref as R
from repro.models import mamba as jmamba
from repro.models import rglru as jrglru
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.models import init_params, mamba, rglru
from repro_torch.serve.engine import Request, ServeEngine
from torch_lm import assert_streams_agree, record_tick_logits

STATE_TOL = 1e-5
KINDS = {"rglru": ("recurrentgemma-2b", jrglru, rglru, "h"),
         "mamba": ("falcon-mamba-7b", jmamba, mamba, "ssm")}


def _layer(kind, seed=0):
    name, jmod, mod, _ = KINDS[kind]
    cfg, jcfg = R.configs_of(name)
    init = getattr(jmod, f"init_{kind}_params")
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.key(seed), jcfg))
    layer = (rglru.RGLRU if kind == "rglru" else mamba.Mamba)(cfg,
                                                              device="cpu")
    assert sorted(n for n, _ in layer.named_parameters()) == sorted(jp)
    for n, arr in jp.items():
        getattr(layer, n).copy_(torch.from_numpy(np.array(arr)))
    # the f32 leaves stay f32
    f32 = {"rglru": {"lam"}, "mamba": {"A_log", "D", "dt_bias"}}[kind]
    assert {n for n, p in layer.named_parameters()
            if p.dtype == torch.float32} == f32
    return cfg, jcfg, jp, layer


def _state_shape(kind, cfg, b):
    if kind == "rglru":
        return (b, cfg.lru_width)
    return (b, cfg.d_inner, cfg.ssm.d_state)


def _both(fn_ref, fn_port):
    """The reference op by op and compiled, and the port."""
    with jax.disable_jit():
        eager = fn_ref()
    return eager, jax.jit(fn_ref)(), fn_port()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("s_len,with_state", [(7, False), (7, True),
                                              (512, True)])
def test_apply_with_state(kind, s_len, with_state):
    """The prefill form with ``return_state=True``: the output and the state
    after the last token, from zeros or a given state; 512 tokens run two
    chunks."""
    cfg, jcfg, jp, layer = _layer(kind)
    rng = np.random.default_rng(s_len)
    x = rng.normal(size=(2, s_len, cfg.d_model)).astype(np.float32)
    st = rng.normal(size=_state_shape(kind, cfg, 2)).astype(np.float32) \
        if with_state else None
    apply_ref = getattr(KINDS[kind][1], f"{kind}_apply")
    apply = getattr(KINDS[kind][2], f"{kind}_apply")
    eager, compiled, (y, state) = _both(
        lambda: apply_ref(jp, R.jbf(x), jcfg, return_state=True,
                          state=None if st is None else jnp.asarray(st)),
        lambda: apply(layer, R.tbf(x), cfg, return_state=True,
                      state=None if st is None else torch.from_numpy(st)))
    assert state.dtype == torch.float32 and y.dtype == torch.bfloat16
    for how, (wy, ws), tol in (("op by op", eager, STATE_TOL),
                               ("compiled", compiled, R.TOL)):
        R.close(y, wy, f"{kind} out {how}")
        R.close(state, ws, f"{kind} state {how}", tol)
    assert torch.equal(apply(layer, R.tbf(x), cfg,
                             state=None if st is None else
                             torch.from_numpy(st)), y)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_step(kind):
    """One O(1) decode step from a random cache: the output, the conv
    window shifted by one, and the new state."""
    cfg, jcfg, jp, layer = _layer(kind, seed=1)
    rng = np.random.default_rng(3)
    width = cfg.lru_width if kind == "rglru" else cfg.d_inner
    taps = 3 if kind == "rglru" else cfg.ssm.d_conv - 1
    conv = rng.normal(size=(3, taps, width)).astype(np.float32)
    st = rng.normal(size=_state_shape(kind, cfg, 3)).astype(np.float32)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    key = KINDS[kind][3]
    decode_ref = getattr(KINDS[kind][1], f"{kind}_decode")
    decode = getattr(KINDS[kind][2], f"{kind}_decode")
    eager, compiled, (y, cache) = _both(
        lambda: decode_ref(jp, R.jbf(x), {"conv": R.jbf(conv),
                                          key: jnp.asarray(st)}, jcfg),
        lambda: decode(layer, R.tbf(x), {"conv": R.tbf(conv),
                                         key: torch.from_numpy(st)}, cfg))
    assert cache[key].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    for how, (wy, wc), tol in (("op by op", eager, STATE_TOL),
                               ("compiled", compiled, R.TOL)):
        R.close(y, wy, f"{kind} decode out {how}")
        R.close(cache["conv"], wc["conv"], f"{kind} conv {how}", 0)
        R.close(cache[key], wc[key], f"{kind} state {how}", tol)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_prefill_then_decode_equals_a_longer_prefill(kind):
    """The state and conv window a prefill leaves, stepped by one decode,
    give the state and output of a prefill one token longer."""
    cfg, _, _, layer = _layer(kind, seed=2)
    x = R.tbf(np.random.default_rng(4).normal(size=(2, 9, cfg.d_model)))
    apply = getattr(KINDS[kind][2], f"{kind}_apply")
    decode = getattr(KINDS[kind][2], f"{kind}_decode")
    in_proj = x[:, :8] @ layer.in_proj
    taps = 3 if kind == "rglru" else cfg.ssm.d_conv - 1
    conv = in_proj[:, -taps:, :in_proj.shape[-1] // 2]
    _, state = apply(layer, x[:, :8], cfg, return_state=True)
    y, cache = decode(layer, x[:, 8:], {"conv": conv,
                                        KINDS[kind][3]: state}, cfg)
    full, state9 = apply(layer, x, cfg, return_state=True)
    assert torch.equal(cache[KINDS[kind][3]], state9)
    assert torch.equal(y, full[:, 8:])


@pytest.fixture(scope="module", params=sorted(KINDS))
def reduced_runs(request):
    cfg, jcfg = R.configs_of(KINDS[request.param][0])
    jp, model = R.models_of(cfg, jcfg)
    inp, toks = R.inputs_of(cfg, 6)
    return (request.param, R.run_port(model, cfg, inp, toks),
            R.run_reference(jp, jcfg, inp, toks, op_by_op=False),
            R.run_reference(jp, jcfg, inp, toks, op_by_op=True))


@pytest.mark.parametrize("how", ["compiled", "op_by_op"])
def test_reduced_recurrent_model_matches_the_reference(reduced_runs, how):
    """Prefill (logits, the conv windows, the f32 states, recurrentgemma's
    K/V) and four teacher-forced decode steps: against the compiled
    reference at ``COMPILED_TOL`` beyond its own spread, and the reference
    run op by op at ``TOL``."""
    kind, got, compiled, op_by_op = reduced_runs
    if how == "compiled":
        R.hold_compiled(got, compiled, op_by_op)
    else:
        R.hold(got, op_by_op, R.TOL, "op by op")
    key = KINDS[kind][3]
    layers = [c for c in got[0][1] if key in c]
    assert layers and all(c[key].dtype == torch.float32 for c in layers)


def _streams(eng, make, prompts, admit_b_after):
    """Request 0 alone; then request 1 submitted after ``admit_b_after``
    ticks; drained.  Returns ``{rid: tokens}``."""
    eng.submit(make(0, prompts[0], 8))
    for _ in range(admit_b_after):
        eng.step()
    eng.submit(make(1, prompts[1], 6))
    eng.run()
    return {r.rid: r.out for r in eng.completed}


def test_engine_carries_the_recurrent_state_fault():
    """The reduced recurrentgemma through both engines (2 slots): request
    0, then request 1 admitted two ticks later.  The port's streams equal
    the JAX engine's under the margin rule (tests/torch_lm.py), and so does
    request 0 served alone; request 0's stream with a neighbour differs
    from its stream alone in both engines: the neighbour's full-batch
    prefill steps advance request 0's recurrent state too."""
    cfg, jcfg = R.configs_of("recurrentgemma-2b")
    jp, model = R.models_of(cfg, jcfg, seed=3)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]
    runs = {}
    for who, make_engine, make in (
            ("jax", lambda: JEngine(jcfg, jp, batch=2, max_seq=32), JRequest),
            ("port", lambda: ServeEngine(cfg, model, batch=2, max_seq=32,
                                         device="cpu"), Request)):
        eng = make_engine()
        logits = record_tick_logits(eng)
        both = _streams(eng, make, prompts, 2)
        alone_eng = make_engine()
        alone_logits = record_tick_logits(alone_eng)
        alone_eng.submit(make(0, prompts[0], 8))
        alone_eng.run()
        runs[who] = (both, logits, alone_eng.completed[0].out, alone_logits)
    (jboth, jlogits, jalone, jalone_logits), (both, _, alone, _) = \
        runs["jax"], runs["port"]
    assert_streams_agree(both, jboth, jlogits)
    assert_streams_agree({0: alone}, {0: jalone}, jalone_logits)
    assert jboth[0] != jalone and both[0] != alone
    assert jboth[0][:2] == jalone[:2] and both[0][:2] == alone[:2]


def test_init_params_and_caches_of_the_recurrent_kinds():
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_caches
    cfg = reduced_config("falcon-mamba-7b")
    model = init_params(cfg, 5, device="cpu")
    blk = model.layers[0]
    assert not hasattr(blk, "norm2") and not hasattr(blk, "mlp")
    m = blk.mamba
    assert m.A_log.dtype == torch.float32
    assert torch.allclose(m.A_log[3], torch.log(torch.arange(1.0, 5.0)))
    assert torch.allclose(torch.nn.functional.softplus(m.dt_bias),
                          torch.full_like(m.dt_bias, 0.01))
    assert bool((m.D == 1).all()) and not m.conv_b.any()
    caches = init_caches(cfg, 3, 16, device="cpu")
    assert caches[0]["conv"].shape == (3, 3, cfg.d_inner)
    assert caches[0]["ssm"].shape == (3, cfg.d_inner, cfg.ssm.d_state)
    rg = reduced_config("recurrentgemma-2b")
    kinds = [b.kind for b in init_params(rg, 5, device="cpu").layers]
    assert kinds == ["rglru", "rglru", "attn"] * 2
    caches = init_caches(rg, 2, 16, device="cpu")
    assert caches[0]["h"].dtype == torch.float32
    assert caches[0]["h"].shape == (2, rg.lru_width)
    assert caches[2]["k"].shape == (2, 16, rg.num_kv_heads, rg.head_dim)
