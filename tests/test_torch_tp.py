"""The port's tensor-parallel execution held against the JAX package on the
CPU at ``tp = 3``: a 3-rank gloo world on a ``(1, 3)`` ``("data",
"model")`` mesh (``tests/torch_tp_world.py``) runs every reduced arch from
the reference's ``init_params(key, cfg, 3)``.  Three pads the 4 query
heads to 6, splits the GQA groups across ranks (``G = 3``: rank 1's heads
2 and 3 read different KV heads), keeps ``embed``, ``d_ff``, the MoE and
the recurrent kinds whole (256, 128, 4 experts of 64, 128 and 64 channels:
3 divides none), and splits the KV caches over their 36 positions (2 KV
heads).  ``tests/test_torch_tp_train.py`` does ``tp = 2`` and the
training steps.

The reference's loss, gradients, prefill logits and three teacher-forced
decode steps' logits are computed in-process on one CPU device, op by op
(the same function the partitioner spreads over a mesh), while the world
runs.  Tolerances: ``torch_train_ref.LOSS_RTOL`` (5e-4) and ``GRAD_TOL``
(5e-2 of a leaf's largest magnitude), ``torch_models_ref.TOL`` (2e-2) for
logits.
"""
import jax
import numpy as np
import pytest
import torch

import torch_tp_ref as T
import torch_tp_world as W
import torch_train_ref as R
from repro import configs as jconfigs
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro_torch import configs
from repro_torch.models import loss_fn, params_from_jax
from repro_torch.models.attention import _kv_plan

TP = 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp3")
    refs, weights = {}, {}
    for arch in T.ARCHS:
        jp = jinit(jax.random.key(T.SEED), jconfigs.reduced_config(arch), TP)
        weights.update({f"w.{arch}.{k}": v
                        for k, v in T.flat_params(jp).items()})
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **weights)
    d, n, wait = T.spawn_world(tmp, "w13", (1, TP), ["forward"], inputs,
                               archs=list(T.ARCHS))
    for arch in T.ARCHS:
        refs[arch] = T.reference(arch, TP)[1]
    errors = wait()
    return d, n, errors, refs


@pytest.mark.parametrize("arch", T.ARCHS)
def test_tp3_matches_the_reference(world, arch):
    d, _, errors, refs = world
    T.hold_forward(T.case(d, errors, "forward", 0), arch, refs[arch])


@pytest.mark.parametrize("arch", T.ARCHS)
def test_tp3_each_rank_holds_its_pieces(world, arch):
    d, n, errors, _ = world
    for rank in range(n):
        T.hold_pieces(T.case(d, errors, "forward", rank), arch, TP)


def test_tp3_ranks_agree_bitwise(world):
    d, n, errors, _ = world
    first = T.case(d, errors, "forward", 0)
    for rank in range(1, n):
        got = T.case(d, errors, "forward", rank)
        for k, v in first.items():
            if ".numel." not in k and ".cache." not in k:
                assert np.array_equal(got[k], v), (rank, k)


def test_padding_regroups_real_heads_in_both_packages():
    """A reference quirk the port keeps (ROADMAP, Carried notes): the GQA
    grouping is ``h // kh`` over the *padded* count, so padding moves real
    heads to other KV heads.  The reduced phi4-mini's ``tp = 1`` params
    with two zero heads appended (its shape at ``tp = 3``: 6 heads, ``G =
    3``, head 2 now reads KV head 0) give another loss than at ``tp = 1``
    (``G = 2``); the port equals the reference at both shapes."""
    arch = "phi4-mini-3.8b"
    cfg, jcfg = configs.reduced_config(arch), jconfigs.reduced_config(arch)
    jp = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(0), jcfg))
    padded = jax.tree_util.tree_map(np.array, jp)
    for seg in padded:
        if not seg.startswith("seg"):
            continue
        attn = padded[seg]["sub0"]["attn"]
        attn["wq"] = np.pad(attn["wq"], ((0, 0), (0, 0), (0, 2), (0, 0)))
        attn["wo"] = np.pad(attn["wo"], ((0, 0), (0, 2), (0, 0), (0, 0)))
    batch = W.kind_batch(cfg)
    with jax.disable_jit():
        ref1 = float(jloss(jp, R.jax_batch(batch), jcfg, 1))
        ref3 = float(jloss(padded, R.jax_batch(batch), jcfg, 3))
    assert abs(ref3 - ref1) > R.LOSS_RTOL * abs(ref1), (ref1, ref3)
    for tree, tp, want in ((jp, 1, ref1), (padded, 3, ref3)):
        model = params_from_jax(tree, cfg, device="cpu", dtype=torch.float32,
                                tp=tp)
        with torch.no_grad():
            got = float(loss_fn(model, W.torch_batch(batch), cfg))
        np.testing.assert_allclose(got, want, rtol=R.LOSS_RTOL,
                                   err_msg=f"tp={tp}")


@pytest.mark.parametrize("h_pad,kh,tp,how", [
    (6, 2, 3, "slice"),      # the reduced configs at tp = 3: G = 3
    (6, 1, 3, "slice"),      # one KV head
    (4, 2, 2, "slice"),      # KV heads split with the query heads
    (48, 8, 3, "index"),     # nemotron-4-15b at tp = 3: 16 heads, G = 6
    (24, 8, 4, "slice"),     # phi4-mini-3.8b at tp = 4
])
def test_kv_plan_maps_each_head_to_head_over_g(h_pad, kh, tp, how):
    """Every rank's plan (``attention._kv_plan``) maps its query head ``i``
    to KV head ``i // G`` (``G = h_pad // kh``), in one form for all
    ranks; an uneven straddle takes the index form."""
    g, hl = h_pad // kh, h_pad // tp
    for split in ((False, True) if kh % tp == 0 else (False,)):
        form, plans = _kv_plan(h_pad, kh, tp, split)
        assert form == how
        for r, plan in enumerate(plans):
            k0 = r * (kh // tp) if split else 0
            heads = range(r * hl, (r + 1) * hl)
            if form == "slice":
                a, b = plan
                got = [a + i // (hl // (b - a)) for i in range(hl)]
            else:
                got = list(plan)
            assert got == [h // g - k0 for h in heads], (r, plan)
