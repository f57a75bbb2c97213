"""The port's training pieces (``repro_torch.train``,
``repro_torch.distributed.compression``, ``repro_torch.data.synthetic``,
the remat policies) against the JAX package's, on the CPU.

Tolerances (``tests/torch_train_ref.py`` gives the measured errors):
the int8 payloads, error buffers and token ids are held bitwise,
``schedule`` bitwise in its warm-up and within 1e-6 of ``lr`` after it;
``global_norm``, the clip and ``adamw_update`` at 1e-6 relative
(``add_``/``addcmul_`` may fuse a multiply and an add that the reference
rounds apart: measured one f32 ulp); normal draws at ``NORMAL_RTOL``;
training steps against the compiled reference at ``TRAIN_RTOL`` and
``PARAM_ATOL``.  The remat policies are held bitwise against no remat.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_train_ref as R
from repro import configs as jconfigs
from repro.data.synthetic import synthetic_batch as jsynthetic
from repro.distributed import compression as jcomp
from repro.train import optimizer as jopt
from repro.train.state import init_state as jinit_state
from repro.train.step import make_train_step as jmake_step
from repro_torch import configs
from repro_torch.data import prng
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.distributed import compression
from repro_torch.models import REMAT_POLICIES, init_params, loss_fn
from repro_torch.train import optimizer
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step

NORMAL_RTOL = 2e-5      # torch.erfinv against XLA's: 5.8e-6 over 10**6 draws
OPT_RTOL = 1e-6
CFG_NAME = "phi4-mini-3.8b"
OC = dict(lr=1e-3, warmup_steps=2, decay_steps=100)

# a port parameter's name and shape, and its leaf's shape in the
# reference (per-layer leaves stacked over one layer here)
LEAVES = {"embed": (50, 8), "final_norm": (8,), "layers.0.norm1": (8,),
          "layers.0.attn.wq": (8, 2, 4), "layers.0.rglru.lam": (8,)}


def _ref_shape(name, shape):
    return (1,) + shape if name.startswith("layers.") else shape


def _leaves(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = {}
    for n, s in LEAVES.items():
        x = rng.normal(size=s).astype(np.float32) * scale
        out[n] = np.abs(x) if positive else x
    return out


def _t(leaves):
    return {n: torch.from_numpy(v.copy()) for n, v in leaves.items()}


def _j(leaves):
    return {n: jnp.asarray(v.reshape(_ref_shape(n, v.shape)))
            for n, v in leaves.items()}


def _close(got, want, rtol=OPT_RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).reshape(np.shape(got))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("step", [0, 1, 2, 5, 50, 99, 101, 150])
def test_schedule_matches_the_reference(step):
    """Bitwise in the warm-up; past it within 1e-6 of ``lr`` (``torch.cos``
    and XLA's differ by an ulp, and ``1 + cos`` cancels near the end of the
    decay: measured 3e-11 at step 99)."""
    oc, joc = optimizer.OptimizerConfig(**OC), jopt.OptimizerConfig(**OC)
    got = optimizer.schedule(torch.tensor(step, dtype=torch.int32), oc)
    want = np.float32(jopt.schedule(jnp.int32(step), joc))
    assert got.dtype == torch.float32
    if step < oc.warmup_steps or step >= oc.warmup_steps + oc.decay_steps:
        assert np.float32(got.item()) == want
    else:
        assert abs(got.item() - want) <= OPT_RTOL * oc.lr


def test_global_norm_and_clip_match_the_reference():
    g = _leaves(1, 3.0)
    want_clip, want_norm = jopt.clip_by_global_norm(_j(g), 1.0)
    tg = _t(g)
    _close(optimizer.global_norm(tg.values()), jopt.global_norm(_j(g)))
    scratch = optimizer.make_scratch(tg.values())
    assert scratch.numel() == 400
    got, norm = optimizer.clip_by_global_norm(tg, 1.0, scratch)
    assert got is tg                                   # in place
    _close(norm, want_norm)
    for n in g:
        _close(got[n], want_clip[n], what=n)
    _close(optimizer.global_norm(got.values()), 1.0)
    # a norm under the limit leaves the gradients as they were
    small = {n: v * 1e-4 for n, v in g.items()}
    got, _ = optimizer.clip_by_global_norm(_t(small), 1.0)
    assert all(np.array_equal(got[n].numpy(), small[n]) for n in small)


@pytest.mark.parametrize("step", [0, 3, 7])
def test_adamw_update_matches_the_reference(step):
    p, g, m = _leaves(2), _leaves(3, 3.0), _leaves(4, 0.1)
    v = _leaves(5, 0.01, positive=True)
    oc, joc = optimizer.OptimizerConfig(**OC), jopt.OptimizerConfig(**OC)
    jp, jm, jv, jlr = jopt.adamw_update(_j(p), _j(g), _j(m), _j(v),
                                        jnp.int32(step), joc)
    tp, tg, tm, tv = _t(p), _t(g), _t(m), _t(v)
    out = optimizer.adamw_update(tp, tg, tm, tv,
                                 torch.tensor(step, dtype=torch.int32), oc,
                                 optimizer.make_scratch(tp.values()))
    assert out[0] is tp and out[1] is tm and out[2] is tv   # in place
    assert np.float32(out[3].item()) == np.float32(jlr)
    for n in p:
        _close(tp[n], jp[n], what=f"param {n}")
        _close(tm[n], jm[n], what=f"mu {n}")
        _close(tv[n], jv[n], what=f"nu {n}")


def test_weight_decay_follows_the_reference_s_stacked_rank():
    """The reference decays leaves of rank >= 2; its per-layer leaves carry
    a layer axis, so a layer's ``(d,)`` norm (and ``lam``) decays and only
    ``final_norm`` does not.  With zero gradients and moments the update
    is the decay alone."""
    p = _leaves(6)
    zero = {n: np.zeros_like(x) for n, x in p.items()}
    oc, joc = optimizer.OptimizerConfig(**OC), jopt.OptimizerConfig(**OC)
    jp, *_ = jopt.adamw_update(_j(p), _j(zero), _j(zero), _j(zero),
                               jnp.int32(5), joc)
    tp = _t(p)
    optimizer.adamw_update(tp, _t(zero), _t(zero), _t(zero),
                           torch.tensor(5, dtype=torch.int32), oc)
    for n in p:
        _close(tp[n], jp[n], what=n)
        decayed = not np.array_equal(tp[n].numpy(), p[n])
        assert decayed == (n != "final_norm"), n


def test_quantize_int8_payload_is_the_reference_bitwise():
    rng = np.random.default_rng(8)
    x = rng.normal(size=4099).astype(np.float32)
    x[:3] = [0.5, -0.5, 1.5]                 # ties round half to even
    for arr in (x, x * 1e-20, np.zeros(5, np.float32)):
        q, s = compression.quantize_int8(torch.from_numpy(arr))
        jq, js = jcomp.quantize_int8(jnp.asarray(arr))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s.item()) == np.float32(js)
        assert np.array_equal(compression.dequantize_int8(q, s).numpy(),
                              np.asarray(jcomp.dequantize_int8(jq, js)))


def test_compress_with_feedback_is_the_reference_bitwise():
    g, e = _leaves(9, 2.0), _leaves(10, 0.01)
    jg, je = jcomp.compress_with_feedback(_j(g), _j(e))
    tg, te = compression.compress_with_feedback(_t(g), _t(e))
    for n in g:
        assert np.array_equal(tg[n].numpy(),
                              np.asarray(jg[n]).reshape(LEAVES[n])), n
        assert np.array_equal(te[n].numpy(),
                              np.asarray(je[n]).reshape(LEAVES[n])), n
    zero = compression.init_error_buf(_t(g))
    assert all(z.dtype == torch.float32 and not z.any() for z in zero.values())


def test_uniform_draws_are_jax_s_bitwise():
    k = jax.random.key(3)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    assert np.array_equal(prng.uniform(prng.key(3), (999, 7)).numpy(),
                          np.asarray(jax.random.uniform(k, (999, 7))))
    assert np.array_equal(
        prng.uniform(prng.key(3), (50000,), lo, 1.0).numpy(),
        np.asarray(jax.random.uniform(k, (50000,), minval=lo, maxval=1.0)))
    got = prng.normal(prng.key(3), (50000,)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.random.normal(k, (50000,))),
                               rtol=NORMAL_RTOL, atol=NORMAL_RTOL)


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_synthetic_batch_matches_the_reference(name):
    """Every arch's kind of batch: tokens and labels bitwise; frames and
    image embeddings at ``NORMAL_RTOL``; the same step again is the same
    batch, another step another."""
    cfg, jcfg = configs.reduced_config(name), jconfigs.reduced_config(name)
    got = synthetic_batch(cfg, 3, 16, 5, device="cpu")
    want = jsynthetic(jcfg, 3, 16, 5)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype.kind == "i":
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), w), k
        else:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=NORMAL_RTOL,
                                       atol=NORMAL_RTOL, err_msg=k)
    again = synthetic_batch(cfg, 3, 16, 5, device="cpu")
    other = synthetic_batch(cfg, 3, 16, 6, device="cpu")
    assert all(torch.equal(again[k], got[k]) for k in got)
    assert not torch.equal(other["labels"], got["labels"])


def test_synthetic_batch_at_the_full_vocab():
    cfg = configs.get_config(CFG_NAME)
    got = synthetic_batch(cfg, 2, 64, 3, device="cpu")
    want = jsynthetic(jconfigs.get_config(CFG_NAME), 2, 64, 3)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def _run_both(accum=1, compression_on=False, steps=4, b=8):
    """``steps`` steps of each package's ``make_train_step`` on the same
    weights and fixed batch: (port history, reference history, the port's
    state, the reference's state)."""
    cfg, jcfg, jp, model = R.models_of(CFG_NAME)
    batch = R.fixed_batch(cfg, b=b)
    jstate = jinit_state(jp, compression=compression_on)
    jstep = jax.jit(jmake_step(jcfg, jopt.OptimizerConfig(**OC),
                               accum_steps=accum,
                               compression=compression_on))
    state = init_state(model, compression=compression_on)
    step = make_train_step(cfg, optimizer.OptimizerConfig(**OC),
                           accum_steps=accum, compression=compression_on)
    jb, tb = R.jax_batch(batch), R.torch_batch(batch)
    got, want = [], []
    for _ in range(steps):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        want.append({k: float(v) for k, v in jm.items()})
        got.append({k: float(v) for k, v in m.items()})
    return got, want, state, jstate


def _hold_history(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=R.TRAIN_RTOL,
                                   err_msg=f"loss step {i}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=5 * R.TRAIN_RTOL,
                                   err_msg=f"grad norm step {i}")
        assert abs(g["lr"] - w["lr"]) <= OPT_RTOL * OC["lr"], i


@pytest.mark.parametrize("accum", [1, 4])
def test_train_steps_match_the_reference(accum):
    got, want, state, jstate = _run_both(accum=accum)
    _hold_history(got, want)
    assert int(state.step) == 4 and state.step.dtype == torch.int32
    pairs = R.port_params_as_reference(state.params, jstate.params)
    for n, (p, w) in pairs.items():
        np.testing.assert_allclose(p, w, rtol=0, atol=R.PARAM_ATOL,
                                   err_msg=n)


def test_loss_decreases_on_fixed_batch():
    cfg = configs.reduced_config(CFG_NAME)
    state = init_state(init_params(cfg, 0, device="cpu",
                                   dtype=torch.float32))
    step = make_train_step(cfg, optimizer.OptimizerConfig(**OC))
    batch = R.torch_batch(R.fixed_batch(cfg))
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_grad_accum_matches_full_batch():
    """The reference's own tolerance for the same check
    (tests/test_train.py)."""
    cfg, _, _, model = R.models_of(CFG_NAME)
    other = copy.deepcopy(model)
    batch = R.torch_batch(R.fixed_batch(cfg, b=8))
    oc = optimizer.OptimizerConfig(**OC)
    s1, m1 = make_train_step(cfg, oc, accum_steps=1)(init_state(model), batch)
    s4, m4 = make_train_step(cfg, oc, accum_steps=4)(init_state(other), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, b in zip(s1.params.parameters(), s4.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, oc, accum_steps=3)(s1, batch)


def test_compressed_training_matches_the_reference_and_converges():
    got, want, state, jstate = _run_both(compression_on=True, steps=12,
                                         b=4)
    _hold_history(got[:4], want[:4])
    losses = [h["loss"] for h in got]
    assert losses[-1] < losses[0] * 0.8, losses
    err = float(optimizer.global_norm(state.error.values()))
    assert err > 0.0        # quantization residue is being carried
    np.testing.assert_allclose(
        err, float(jopt.global_norm(jstate.error)), rtol=0.1)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "mixtral-8x22b"])
def test_remat_policies_change_memory_never_values(name):
    """Each policy gives the loss and every gradient of no remat, bitwise;
    the backward pass recomputes the forward's matrix products under
    ``full``/``nothing``, none under ``dots``/``everything``, and only the
    batched ones under ``dots_no_batch``."""
    cfg = configs.reduced_config(name)
    model = init_params(cfg, 1, device="cpu", dtype=torch.float32)
    batch = R.torch_batch(R.kind_batch(cfg, b=2, s=16))

    def run(policy):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch, cfg, policy)
        with _CountMM() as count:
            loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in model.named_parameters()}, \
            count.mm

    loss0, grads0, mm0 = run(None)
    seen = {}
    for policy in REMAT_POLICIES:
        loss, grads, seen[policy] = run(policy)
        assert torch.equal(loss, loss0), policy
        for n in grads0:
            assert torch.equal(grads[n], grads0[n]), (policy, n)
    assert seen["everything"] == seen["dots"] == mm0
    assert seen["full"] == seen["nothing"] > seen["dots_no_batch"] > mm0
