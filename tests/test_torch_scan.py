"""The recurrences' chunked scan (``repro_torch.kernels.linear_scan``, the
op ``repro::linear_scan``) on the CPU, against the JAX package's.

* The plain version runs jax's odd/even recursion of
  ``jax.lax.associative_scan`` with the reference's combine ``(a1 * a2, b1
  * a2 + b2)`` and then ``h = cA * h0 + cB``: against jax run op by op on
  the same numpy inputs it is bitwise (the same float ops in the same
  order); against jax compiled within ``COMPILED_TOL`` (XLA may contract a
  multiply and an add into one FMA); against a float64 sequential loop
  within ``F64_TOL``, relative and absolute (f32 rounding over log2(T)
  levels of combines; the states are at most about 20 in size here).
  Forward and reverse, T in {1, 7, 256, 300}, a zero and a random
  ``h0``.
* ``torch.library.opcheck`` (schema, fake implementation, autograd
  registration, traced dispatch) and ``torch.autograd.gradcheck`` in
  float64 on the op.
* The gradients of one Mamba chunk (the reference's ``_scan_chunk``,
  ``repro/models/mamba.py:54``) and one RG-LRU chunk (the body of the
  reference's outer scan, ``repro/models/rglru.py:67-76``) against
  ``jax.vjp`` of the reference, within ``GRAD_TOL`` of each gradient's
  largest magnitude (the backward is a reversed scan here and jax's
  transposed recursion there: f32 rounding in another order).
* ``mamba_mix`` and ``rglru_mix`` call the op once a chunk and have no
  loop over tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_models_ref as R
from repro.models import mamba as jmamba
from repro_torch import kernels
from repro_torch.kernels.linear_scan import linear_scan_op, ops
from repro_torch.models import mamba, rglru

COMPILED_TOL = 1e-5
F64_TOL = 1e-5
GRAD_TOL = 1e-5
STEPS = (1, 7, 256, 300)


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, b1 * a2 + b2


def _jax_scan(a, b, h0, reverse):
    ca, cb = jax.lax.associative_scan(_combine, (a, b), axis=1,
                                      reverse=reverse)
    return ca * h0[:, None] + cb


def _inputs(seed, steps, channels=37, rows=2, zero_h0=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, size=(rows, steps, channels)).astype(
        np.float32)
    b = rng.normal(size=(rows, steps, channels)).astype(np.float32)
    h0 = (np.zeros((rows, channels), np.float32) if zero_h0 else
          rng.normal(size=(rows, channels)).astype(np.float32))
    return a, b, h0


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("zero_h0", [False, True])
@pytest.mark.parametrize("steps", STEPS)
def test_plain_scan_is_jax_s_associative_scan(steps, zero_h0, reverse):
    a, b, h0 = _inputs(steps, steps, zero_h0=zero_h0)
    got = kernels.linear_scan(*map(torch.from_numpy, (a, b, h0)),
                              reverse=reverse).numpy()
    with jax.disable_jit():
        op_by_op = np.asarray(_jax_scan(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(h0), reverse))
    compiled = np.asarray(jax.jit(_jax_scan, static_argnums=3)(
        a, b, h0, reverse))
    np.testing.assert_array_equal(got, op_by_op)
    np.testing.assert_allclose(got, compiled, rtol=COMPILED_TOL,
                               atol=COMPILED_TOL)
    loop = kernels.linear_scan_loop(
        *(torch.from_numpy(x).double() for x in (a, b, h0)),
        reverse=reverse).numpy()
    np.testing.assert_allclose(got, loop, rtol=F64_TOL, atol=F64_TOL)
    assert got.shape == a.shape and got.dtype == np.float32


def test_h0_defaults_to_zeros_and_shapes_are_checked():
    a, b, _ = _inputs(0, 9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(kernels.linear_scan(ta, tb),
                       kernels.linear_scan(ta, tb, torch.zeros(2, 37)))
    with pytest.raises(ValueError, match="one shape"):
        kernels.linear_scan(ta, tb[:, 1:])
    with pytest.raises(ValueError, match="h0 must be"):
        kernels.linear_scan(ta, tb, torch.zeros(2, 36))
    with pytest.raises(ValueError, match="float dtype"):
        kernels.linear_scan(ta, tb.double())
    empty = kernels.linear_scan(ta[:, :0], tb[:, :0], torch.zeros(2, 37))
    assert empty.shape == (2, 0, 37)


@pytest.mark.parametrize("reverse", [False, True])
def test_opcheck(reverse):
    a, b, h0 = (torch.from_numpy(x).requires_grad_()
                for x in _inputs(1, 11, channels=5))
    torch.library.opcheck(linear_scan_op, (a, b, h0, reverse))
    torch.library.opcheck(linear_scan_op, (a.detach(), b.detach(),
                                           h0.detach(), reverse))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("steps", [1, 2, 7])
def test_gradcheck_float64(steps, reverse):
    a, b, h0 = (torch.from_numpy(x).double().requires_grad_()
                for x in _inputs(steps, steps, channels=3))
    assert torch.autograd.gradcheck(
        lambda a, b, h0: linear_scan_op(a, b, h0, reverse), (a, b, h0))


@pytest.mark.parametrize("reverse", [False, True])
def test_op_gradients_equal_the_plain_version_s_autograd(reverse):
    """The registered backward (a reversed scan) against autograd through
    the plain version's ops."""
    a, b, h0 = _inputs(5, 300)
    gh = torch.from_numpy(np.random.default_rng(6).normal(
        size=a.shape).astype(np.float32))
    grads = []
    for fn in (lambda *x: linear_scan_op(*x, reverse),
               lambda *x: kernels.linear_scan_ref(*x, reverse)):
        xs = [torch.from_numpy(x).requires_grad_() for x in (a, b, h0)]
        (fn(*xs) * gh).sum().backward()
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= GRAD_TOL * scale


def _vjp_check(port_fn, ref_fn, inputs, cotangents):
    """The port's gradients of ``inputs`` (numpy) under ``cotangents``
    against ``jax.vjp`` of ``ref_fn``, each within ``GRAD_TOL`` of its
    largest magnitude."""
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    outs = port_fn(*xs)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    want_outs, vjp = jax.vjp(jax.jit(ref_fn), *map(jnp.asarray, inputs))
    for got, want in zip(outs, want_outs):
        R.close(got, np.asarray(want), "chunk output", F64_TOL)
    for name, x, want in zip("0123", xs, vjp(tuple(map(jnp.asarray,
                                                       cotangents)))):
        want = np.asarray(want)
        err = np.abs(x.grad.numpy() - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (name, err)


def test_mamba_chunk_gradients_match_jax_vjp():
    rng = np.random.default_rng(11)
    b, length, di, n = 2, 256, 16, 4
    state = rng.normal(size=(b, di, n)).astype(np.float32)
    da = rng.uniform(0.3, 0.999, size=(b, length, di, n)).astype(np.float32)
    dbu = (0.1 * rng.normal(size=(b, length, di, n))).astype(np.float32)
    cm = rng.normal(size=(b, length, n)).astype(np.float32)
    cot = (rng.normal(size=(b, di, n)).astype(np.float32),
           rng.normal(size=(b, length, di)).astype(np.float32))
    _vjp_check(mamba._scan_chunk, jmamba._scan_chunk,
               (state, da, dbu, cm), cot)


def _rglru_chunk_ref(st, a, gated):
    """The body of the reference's outer scan over chunks
    (``repro/models/rglru.py:67-76``) after its ``_gates``."""
    ca, cb = jax.lax.associative_scan(_combine, (a, gated), axis=1)
    h = ca * st[:, None] + cb
    return h[:, -1], h


def test_rglru_chunk_gradients_match_jax_vjp():
    rng = np.random.default_rng(12)
    b, length, w = 2, 256, 32
    state = rng.normal(size=(b, w)).astype(np.float32)
    a = rng.uniform(0.3, 0.999, size=(b, length, w)).astype(np.float32)
    gated = (0.1 * rng.normal(size=(b, length, w))).astype(np.float32)
    cot = (rng.normal(size=(b, w)).astype(np.float32),
           rng.normal(size=(b, length, w)).astype(np.float32))
    _vjp_check(rglru._scan_chunk, _rglru_chunk_ref, (state, a, gated), cot)


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_a_layer_scans_once_a_chunk(kind, monkeypatch):
    """768 tokens are 3 of the reference's chunks: 3 calls of the op, each
    over a whole chunk, and the output of every token."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import init_params
    cfg = reduced_config("falcon-mamba-7b" if kind == "mamba"
                         else "recurrentgemma-2b")
    model = init_params(cfg, 3, device="cpu")
    layer = next(getattr(blk, kind) for blk in model.layers
                 if blk.kind == kind)
    mod = mamba if kind == "mamba" else rglru
    calls = []

    def spy(a, b, h0, **kw):
        calls.append(a.shape)
        return ops.linear_scan(a, b, h0, **kw)
    monkeypatch.setattr(mod, "linear_scan", spy)
    x = R.tbf(np.random.default_rng(0).normal(size=(2, 768, cfg.d_model)))
    y, state = getattr(mod, f"{kind}_apply")(layer, x, cfg,
                                              return_state=True)
    assert len(calls) == 3 and {s[1] for s in calls} == {256}
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())
    assert state.untyped_storage().nbytes() == 4 * state.numel()
