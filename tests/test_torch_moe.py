"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) and the
reduced MoE archs against the JAX package's, on the CPU.

``moe_apply`` runs at reduced width (d_model 64, expert d_ff 64) with each
arch's published expert count, top-k and capacity factor (mixtral: 8
experts, top 2, 1.25; llama4-maverick: 128 experts, top 1, 2.0), so that
tokens drop; on a ragged token count (the zero-padded rows are routed to
expert 0 and claim its capacity), on groups that split, and at the
serving path's batch-8 decode shape.  The expert choices of each round
and the kept (token, expert, position) triples are read from the
reference as it runs op by op (its ``jax.nn.one_hot`` and dispatch
``einsum`` calls, spied) and must equal the port's ``route`` exactly; the
output within ``TOL`` of the reference run op by op and compiled, the aux
loss to an f32 ulp.  The reduced mixtral and llama4 models (capacity 8.0:
no drops at that size) prefill and take 4 decode steps
(tests/torch_models_ref.py).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_models_ref as R
from repro.models import config as jmc
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import init_params, moe, params_from_jax

PUBLISHED = {"mixtral-8x22b": (8, 2, 1.25),
             "llama4-maverick-400b-a17b": (128, 1, 2.0)}
# (arch, batch, seq, group_size): one group; a ragged count over split
# groups (39 tokens in groups of 16: 9 padded rows); fewer tokens than a
# group; the serving path's batch-8 decode step
CASES = [(a, b, s, gs) for a in PUBLISHED
         for b, s, gs in ((2, 8, 16), (3, 13, 16), (1, 5, 2048),
                          (8, 1, 2048))]


def _cfgs(arch, group_size):
    e, k, cf = PUBLISHED[arch]
    m = dict(num_experts=e, top_k=k, d_ff=64, group_size=group_size,
             capacity_factor=cf)
    cfg, jcfg = R.configs_of(arch)
    return (dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **m)),
            dataclasses.replace(jcfg, moe=jmc.MoEConfig(**{
                **dataclasses.asdict(jcfg.moe), **m})))


def _layer(cfg, jcfg, seed):
    jp = jax.tree_util.tree_map(np.asarray, jmoe.init_moe_params(
        jax.random.key(seed), jcfg))
    mod = moe.MoE(cfg, device="cpu")
    for name, arr in jp.items():
        getattr(mod, name).copy_(torch.from_numpy(np.array(arr)))
    return jp, mod


def _spied_reference(monkeypatch, jp, x, jcfg):
    """The reference's ``moe_apply`` op by op, with its expert choices (the
    first ``top_k`` one-hots) and its dispatch tensor recorded."""
    hots, dispatch = [], []
    one_hot, einsum = jax.nn.one_hot, jnp.einsum

    def spy_one_hot(idx, n, **kw):
        hots.append(np.asarray(idx))
        return one_hot(idx, n, **kw)

    def spy_einsum(spec, *ops, **kw):
        if spec == "gsd,gsec->gecd":
            dispatch.append(np.asarray(ops[1]).astype(np.float32))
        return einsum(spec, *ops, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", spy_one_hot)
    monkeypatch.setattr(jnp, "einsum", spy_einsum)
    with jax.disable_jit():
        y, aux = jmoe.moe_apply(jp, R.jbf(x), jcfg)
    monkeypatch.undo()
    return y, aux, hots[:jcfg.moe.top_k], dispatch[0]


@pytest.mark.parametrize("arch,b,s,gs", CASES,
                         ids=[f"{a.split('-')[0]}-{b}x{s}-g{gs}"
                              for a, b, s, gs in CASES])
def test_moe_apply_matches_the_reference(monkeypatch, arch, b, s, gs):
    cfg, jcfg = _cfgs(arch, gs)
    jp, mod = _layer(cfg, jcfg, seed=b * 100 + s)
    rng = np.random.default_rng(b * 10 + s)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    want, want_aux, want_choices, want_dispatch = _spied_reference(
        monkeypatch, jp, x, jcfg)

    # the routing: each round's choices, the kept (token, expert, slot)s
    tokens = b * s
    group = min(gs, tokens)
    xt = R.tbf(x).reshape(tokens, -1)
    pad = -(-tokens // group) * group - tokens
    xg = torch.cat([xt, xt.new_zeros((pad, xt.shape[1]))]).view(-1, group,
                                                                 xt.shape[1])
    choices, combined, aux = moe.route(mod, xg, cfg)
    assert [c.numpy().tolist() for c in choices] == \
        [c.tolist() for c in want_choices]
    kept = (combined > 0).numpy()
    assert np.array_equal(kept, want_dispatch > 0)
    chosen = sum(int(c.numel()) for c in choices)
    dropped = chosen - int(kept.sum())
    if arch == "mixtral-8x22b":     # 3, 14, 2 and 7 of 32, 96, 10 and 16
        assert dropped > 0
    if pad:     # the padded rows are routed: their first choice is expert 0
        assert (choices[0].reshape(-1)[tokens:] == 0).all()
    assert aux.item() == pytest.approx(float(want_aux), rel=1e-6)

    y, aux2 = moe.moe_apply(mod, R.tbf(x), cfg)
    assert torch.equal(aux2, aux)
    R.close(y, want, f"{arch} moe_apply op by op")
    jit = jax.jit(jmoe.moe_apply, static_argnums=2)
    cy, caux = jit(jp, R.jbf(x), jcfg)
    R.close(y, cy, f"{arch} moe_apply compiled")
    assert aux.item() == pytest.approx(float(caux), rel=1e-6)


def test_padding_claims_capacity_and_drops(monkeypatch):
    """A zero router ties every expert, so each token's choices are experts
    0 then 1 (the first index).  Five tokens in groups of 4 at mixtral's
    published capacity (``cap = max(int(4 * 2 / 8 * 1.25), 2) = 2``): in
    group 0, tokens 0 and 1 keep both experts and tokens 2 and 3 drop; in
    group 1, token 4 and the first padded row take expert 0's two slots
    and the other padded rows drop."""
    cfg, jcfg = _cfgs("mixtral-8x22b", 4)
    jp, mod = _layer(cfg, jcfg, seed=0)
    jp["router"] = np.zeros_like(jp["router"])
    mod.router.zero_()
    x = np.random.default_rng(0).normal(size=(1, 5, cfg.d_model))
    _, _, want_choices, want_dispatch = _spied_reference(monkeypatch, jp, x,
                                                         jcfg)
    xt = torch.cat([R.tbf(x)[0], torch.zeros((3, cfg.d_model),
                                             dtype=torch.bfloat16)])
    choices, combined, _ = moe.route(mod, xt.view(2, 4, -1), cfg)
    assert [c.tolist() for c in choices] == [[[0] * 4] * 2, [[1] * 4] * 2]
    assert [c.tolist() for c in want_choices] == [[[0] * 4] * 2,
                                                  [[1] * 4] * 2]
    kept = (combined > 0).numpy()
    assert np.array_equal(kept, want_dispatch > 0)
    # (group, row) -> the experts it keeps
    held = {(g, r): sorted(np.flatnonzero(kept[g, r].any(-1)).tolist())
            for g in range(2) for r in range(4)}
    assert held == {(0, 0): [0, 1], (0, 1): [0, 1], (0, 2): [], (0, 3): [],
                    (1, 0): [0, 1], (1, 1): [0, 1], (1, 2): [], (1, 3): []}
    y, _ = moe.moe_apply(mod, R.tbf(x), cfg)
    assert not y[0, 2:4].any() and y[0, 4].any()   # dropped rows add 0


def test_capacity_is_the_reference_expression():
    """``cap = max(int(gs * top_k / E * cf), top_k)``: batch-8 decode gives
    2 for mixtral and 1 for llama4, a 2048-token group 640 and 32."""
    for arch, want in (("mixtral-8x22b", (2, 640)),
                       ("llama4-maverick-400b-a17b", (1, 32))):
        cfg = configs.get_config(arch)
        p = types.SimpleNamespace(router=torch.zeros(
            (4, cfg.moe.num_experts), dtype=torch.bfloat16))
        caps = [moe.route(p, torch.zeros((1, tokens, 4), dtype=torch.bfloat16),
                          cfg)[1].shape[-1] for tokens in (8, 2048)]
        assert tuple(caps) == want


@pytest.fixture(scope="module", params=sorted(PUBLISHED))
def reduced_runs(request):
    cfg, jcfg = R.configs_of(request.param)
    jp, model = R.models_of(cfg, jcfg)
    inp, toks = R.inputs_of(cfg, 6)
    return (request.param, R.run_port(model, cfg, inp, toks),
            R.run_reference(jp, jcfg, inp, toks, op_by_op=False),
            R.run_reference(jp, jcfg, inp, toks, op_by_op=True))


@pytest.mark.parametrize("how", ["compiled", "op_by_op"])
def test_reduced_moe_model_matches_the_reference(reduced_runs, how):
    """Prefill's last-token logits and K/V caches, then four teacher-forced
    decode steps: against the compiled reference at ``COMPILED_TOL``, and
    the reference run op by op at ``TOL``."""
    name, got, compiled, op_by_op = reduced_runs
    if how == "compiled":
        R.hold_compiled(got, compiled, op_by_op)
    else:
        R.hold(got, op_by_op, R.TOL, "op by op")


def test_init_params_draws_experts_one_at_a_time():
    cfg = configs.reduced_config("llama4-maverick-400b-a17b")
    model = init_params(cfg, 7, device="cpu")
    again = init_params(cfg, 7, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    blk = model.layers[0]
    assert not hasattr(blk, "mlp") and blk.moe.w_in.dtype == torch.bfloat16
    m = cfg.moe
    assert blk.moe.w_in.shape == (m.num_experts, cfg.d_model, m.d_ff)
    assert float(blk.moe.w_out.float().std()) == pytest.approx(
        m.d_ff ** -0.5, rel=0.1)
    assert float(blk.moe.w_in.float().std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.1)
    assert not torch.equal(blk.moe.w_in[0], blk.moe.w_in[1])
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + cfg.d_model          # + the final norm


def test_params_from_jax_checks_moe_leaves():
    from repro.models import init_params as jinit
    cfg, jcfg = R.configs_of("mixtral-8x22b")
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(0), jcfg))
    tree["seg0"]["sub0"]["moe"]["w_out"] = \
        tree["seg0"]["sub0"]["moe"]["w_out"][:, :, :, :8]
    with pytest.raises(ValueError, match="moe.w_out"):
        params_from_jax(tree, cfg, device="cpu")
    del tree["seg0"]["sub0"]["moe"]
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(tree, cfg, device="cpu")
