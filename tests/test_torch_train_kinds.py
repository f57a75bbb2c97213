"""The training forward and backward of the six kinds' reduced archs
(dense, MoE, RG-LRU, Mamba, cross-attention, frame inputs) against the
JAX package's, on the CPU: ``loss_fn`` and the gradient of every leaf,
on the same weights (``params_from_jax(..., dtype=F32)``) and numpy
inputs.

Two references: the JAX package run op by op (``jax.disable_jit()``, the
same bf16/f32 sequence as the port) holds the loss at ``LOSS_RTOL`` and
each gradient within ``GRAD_TOL`` of its leaf's largest magnitude; the
compiled one (``jax.jit``, as the reference's own tests run it) holds
them beyond the reference's own compiled/op-by-op spread, through
``hold_compiled`` (``tests/torch_models_ref.py``) on each leaf scaled by
its largest compiled magnitude.  The MoE aux loss is held on its own too.
"""
import jax
import numpy as np
import pytest
import torch

import torch_models_ref as M
import torch_train_ref as R
from repro.models import forward_train as jforward_train
from repro.models import loss_fn as jloss_fn
from repro_torch.models import forward_train, loss_fn
from repro_torch.models.transformer import reference_paths

KINDS = ["phi4-mini-3.8b", "mixtral-8x22b", "recurrentgemma-2b",
         "falcon-mamba-7b", "llama-3.2-vision-11b", "musicgen-large"]


def _batch_for(cfg, batch):
    """Frames stand in for tokens in an embed-stub arch (as in the
    reference's ``_input_embeds``)."""
    return {k: v for k, v in batch.items()
            if not (k == "tokens" and cfg.embed_stub)}


@pytest.mark.parametrize("name", KINDS)
def test_loss_and_grads_match_the_reference(name):
    cfg, jcfg, jp, model = R.models_of(name, seed=1)
    batch = _batch_for(cfg, R.kind_batch(cfg))
    jb = R.jax_batch(batch)

    def jloss(p):
        return jloss_fn(p, jb, jcfg, 1, None)

    with jax.disable_jit():
        op_loss, op_grads = jax.value_and_grad(jloss)(jp)
    c_loss, c_grads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jb, jcfg, 1, "full")))(jp)

    loss = loss_fn(model, R.torch_batch(batch), cfg, "full")
    loss.backward()
    loss = float(loss.detach())
    np.testing.assert_allclose(loss, float(op_loss), rtol=R.LOSS_RTOL)
    spread = abs(float(op_loss) - float(c_loss))
    assert abs(loss - float(c_loss)) <= spread + R.LOSS_RTOL * abs(
        float(c_loss)), (loss, float(c_loss), float(op_loss))

    op, comp = R.flat(op_grads), R.flat(c_grads)
    paths = reference_paths(model)
    got, want_c, want_op = {}, {}, {}
    for n, p in model.named_parameters():
        w_op, w_c = R.at(op, *paths[n]), R.at(comp, *paths[n])
        g = p.grad.numpy()
        scale = float(np.abs(w_op).max())
        assert scale > 0, n
        np.testing.assert_allclose(g, w_op, rtol=0, atol=R.GRAD_TOL * scale,
                                   err_msg=f"{name} grad {n} op by op")
        c_scale = float(np.abs(w_c).max())
        got[n], want_c[n], want_op[n] = (g / c_scale, w_c / c_scale,
                                         w_op / c_scale)
    M.hold_compiled(got, want_c, want_op, f"{name} grads compiled")
    assert sorted(got) == sorted(reference_paths(model))


@pytest.mark.parametrize("name", ["mixtral-8x22b"])
def test_moe_aux_loss_matches_the_reference(name):
    cfg, jcfg, jp, model = R.models_of(name, seed=2)
    batch = R.kind_batch(cfg, b=2, s=16)
    _, jaux = jax.jit(lambda p, b: jforward_train(p, b, jcfg, 1, None))(
        jp, R.jax_batch(batch))
    with torch.no_grad():
        _, aux = forward_train(model, R.torch_batch(batch), cfg, None)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=R.LOSS_RTOL)
    assert float(aux) > 0
