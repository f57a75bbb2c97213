"""The port's checkpoints, training loop and training entry point on the
CPU: checkpoints cross between the packages both ways (the reference's
on-disk layout, leaves bitwise), the reference's checkpoint and
fault-tolerance tests mirrored (tests/test_checkpoint.py, test_ft.py and
test_corpus.py's corpus-as-batch-source), and ``launch.train.main``.

Tolerances: restored leaves bitwise; a resumed run's losses at rtol 1e-6
against the uninterrupted one (the same program on the same CPU); the
port's steps after a restored JAX checkpoint against the JAX package's
at ``TRAIN_RTOL`` (``tests/torch_train_ref.py``).
"""
import os

import jax
import numpy as np
import pytest
import torch

import torch_train_ref as R
from repro.checkpoint import io as jckpt
from repro.models import init_params as jinit
from repro.train import optimizer as jopt
from repro.train.state import init_state as jinit_state
from repro.train.step import make_train_step as jmake_step
from repro_torch import configs, open_graph
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import make_graph_file
from repro_torch.data.corpus import CorpusConfig, WalkCorpus
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.ft.coordinator import Coordinator, FTConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.models.transformer import reference_paths
from repro_torch.train import loop as train_loop
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step

NAME = "phi4-mini-3.8b"
CFG = configs.reduced_config(NAME)
OC = dict(lr=1e-3, warmup_steps=1, decay_steps=50)


def _state(seed=1, compression=False):
    return init_state(init_params(CFG, seed, device="cpu",
                                  dtype=torch.float32),
                      compression=compression)


def _src(i):
    return synthetic_batch(CFG, 2, 16, i, device="cpu")


def _step_fn():
    return make_train_step(CFG, OptimizerConfig(**OC))


def _leaves(state):
    """Every tensor of a state by the reference's checkpoint key (stacked
    leaves as their layers' list)."""
    out = {}
    for k, v in ckpt_io._flatten(state).items():
        if isinstance(v, dict):
            out[k] = [v[j].detach().clone() for j in range(len(v))]
        elif v is not None:
            out[k] = v.detach().clone()
    return out


def _same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, list):
            assert all(torch.equal(p, q) for p, q in zip(x, y)), k
        else:
            assert torch.equal(x, y), k


def _train(state, steps):
    step = _step_fn()
    for i in range(int(state.step), steps):
        state, _ = step(state, _src(i))
    return state


@pytest.mark.parametrize("compression", [False, True])
def test_save_restore_roundtrip(tmp_path, compression):
    state = _train(_state(compression=compression), 2)
    ckpt_io.save(state, str(tmp_path), 7)
    manifest = (tmp_path / "step_00000007" / "manifest.json").read_text()
    assert '"1.seg0.sub0.attn.wq"' in manifest
    assert ('"4.embed"' in manifest) == compression
    fresh = _state(seed=5, compression=compression)
    restored, step = ckpt_io.restore(fresh, str(tmp_path))
    assert step == 7 and restored is fresh
    _same_state(restored, state)
    assert restored.step.dtype == torch.int32 and int(restored.step) == 2


def test_async_save_and_latest_step(tmp_path):
    state = _state()
    h = ckpt_io.save(state, str(tmp_path), 3, async_=True)
    h.join()
    ckpt_io.save(state, str(tmp_path), 9)
    assert ckpt_io.latest_step(str(tmp_path)) == 9


def test_async_save_copies_before_the_next_step(tmp_path):
    """The host copy is taken before ``save`` returns: a step that updates
    the params in place right after an async save does not reach it."""
    state = _state()
    before = _leaves(state)
    h = ckpt_io.save(state, str(tmp_path), 1, async_=True)
    state = _train(state, 2)            # step 0's learning rate is 0
    h.join()
    restored, _ = ckpt_io.restore(_state(seed=4), str(tmp_path), 1)
    assert torch.equal(_leaves(restored)["1.embed"], before["1.embed"])
    assert not torch.equal(_leaves(state)["1.embed"], before["1.embed"])


def test_tmp_dirs_are_not_checkpoints(tmp_path):
    ckpt_io.save(_state(), str(tmp_path), 5)
    os.makedirs(str(tmp_path / "step_00000009.tmp"))
    assert ckpt_io.latest_step(str(tmp_path)) == 5
    assert ckpt_io.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt_io.restore(_state(), str(tmp_path / "none"))


def test_restore_checks_shapes(tmp_path):
    ckpt_io.save(_state(), str(tmp_path), 1)
    import dataclasses
    other = init_state(init_params(dataclasses.replace(CFG, d_ff=64), 1,
                                   device="cpu", dtype=torch.float32))
    with pytest.raises(ValueError, match="mlp"):
        ckpt_io.restore(other, str(tmp_path), 1)


def test_resume_replays_deterministically(tmp_path):
    """Train 6 steps; restart from the step-3 checkpoint; same losses."""
    step_fn = _step_fn()
    state = _state()
    losses = []
    for i in range(6):
        if i == 3:
            ckpt_io.save(state, str(tmp_path), 3)
        state, m = step_fn(state, _src(i))
        losses.append(float(m["loss"]))
    state2, at = ckpt_io.restore(_state(seed=9), str(tmp_path), 3)
    assert at == 3 and int(state2.step) == 3
    losses2 = []
    for i in range(3, 6):
        state2, m = step_fn(state2, _src(i))
        losses2.append(float(m["loss"]))
    np.testing.assert_allclose(losses[3:], losses2, rtol=1e-6)


def _jax_run(tmp_path):
    """The JAX package: 3 steps, a checkpoint at step 3, 3 more steps.
    Returns (its params draw, the last 3 losses)."""
    cfg, jcfg, jp, _ = R.models_of(NAME)
    batch = R.jax_batch(R.fixed_batch(cfg))
    jstep = jax.jit(jmake_step(jcfg, jopt.OptimizerConfig(**OC)))
    js = jinit_state(jp)
    losses = []
    for i in range(6):
        if i == 3:
            jckpt.save(js, str(tmp_path), 3)
        js, m = jstep(js, batch)
        losses.append(float(m["loss"]))
    return jp, losses[3:]


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    jp, want = _jax_run(tmp_path)
    astate = jax.eval_shape(lambda: jinit_state(jinit(jax.random.key(0),
                                                      R.jconfigs
                                                      .reduced_config(NAME))))
    jstate, _ = jckpt.restore(astate, str(tmp_path), 3)
    state, step = ckpt_io.restore(_state(seed=7), str(tmp_path))
    assert step == 3 and int(state.step) == 3
    leaves = {"0": [np.asarray(jstate.step)]}
    for idx, tree in (("1", jstate.params), ("2", jstate.mu),
                      ("3", jstate.nu)):
        for k, v in R.flat(tree).items():
            leaves[f"{idx}.{k}"] = v
    paths = reference_paths(state.params)
    assert np.array_equal(state.step.numpy(), leaves["0"][0])
    for idx, tree in (("1", dict(state.params.named_parameters())),
                      ("2", state.mu), ("3", state.nu)):
        for n, t in tree.items():
            path, j = paths[n]
            assert np.array_equal(t.detach().numpy(),
                                  R.at(leaves, f"{idx}.{path}", j)), (idx, n)
    step_fn = make_train_step(CFG, OptimizerConfig(**OC))
    batch = R.torch_batch(R.fixed_batch(CFG))
    got = []
    for _ in range(3):
        state, m = step_fn(state, batch)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=R.TRAIN_RTOL)


@pytest.mark.parametrize("compression", [False, True])
def test_a_port_checkpoint_restores_in_the_jax_package(tmp_path,
                                                       compression):
    state = _train(_state(compression=compression), 2)
    ckpt_io.save(state, str(tmp_path), 2)
    jcfg = R.jconfigs.reduced_config(NAME)
    astate = jax.eval_shape(lambda: jinit_state(
        jinit(jax.random.key(0), jcfg), compression=compression))
    jstate, step = jckpt.restore(astate, str(tmp_path))
    assert step == 2 and int(jstate.step) == 2
    paths = reference_paths(state.params)
    trees = [("1", jstate.params, dict(state.params.named_parameters())),
             ("2", jstate.mu, state.mu), ("3", jstate.nu, state.nu)]
    if compression:
        trees.append(("4", jstate.error, state.error))
    else:
        assert jstate.error is None
    for idx, jtree, tree in trees:
        leaves = R.flat(jtree)
        for n, t in tree.items():
            assert np.array_equal(t.detach().numpy(),
                                  R.at(leaves, *paths[n])), (idx, n)


def test_failure_injection_and_restart(tmp_path):
    """Crash at step 5, restart from the step-4 checkpoint, finish the run;
    the losses after the restart equal an uninterrupted run's."""
    coord = Coordinator(FTConfig(ckpt_every=2))
    coord.inject_failure(5)
    with pytest.raises(RuntimeError, match="injected"):
        train_loop.run(_state(), _step_fn(), _src, num_steps=8,
                       ckpt_dir=str(tmp_path), coordinator=coord,
                       log=lambda s: None)
    restored, at = ckpt_io.restore(_state(seed=3), str(tmp_path))
    assert at == 4 and int(restored.step) == at
    state2, hist2 = train_loop.run(restored, _step_fn(), _src, num_steps=8,
                                   coordinator=Coordinator(FTConfig()),
                                   log=lambda s: None)
    assert int(state2.step) == 8 and [h["step"] for h in hist2] == [4, 5, 6,
                                                                    7]
    _, hist_ref = train_loop.run(_state(), _step_fn(), _src, num_steps=8,
                                 coordinator=Coordinator(FTConfig()),
                                 log=lambda s: None)
    ref_by_step = {h["step"]: h["loss"] for h in hist_ref}
    for h in hist2:
        np.testing.assert_allclose(h["loss"], ref_by_step[h["step"]],
                                   rtol=1e-6)
    assert set(hist2[0]) == {"step", "loss", "dt", "grad_norm", "lr"}


def test_preemption_checkpoints_and_stops(tmp_path):
    coord = Coordinator(FTConfig(ckpt_every=100))
    calls = {"n": 0}
    real_observe = coord.observe_step

    def observe(dt):
        calls["n"] += 1
        if calls["n"] == 3:
            coord.preempted = True      # simulated SIGTERM
        return real_observe(dt)

    coord.observe_step = observe
    state, hist = train_loop.run(_state(), _step_fn(), _src, num_steps=50,
                                 ckpt_dir=str(tmp_path), coordinator=coord,
                                 log=lambda s: None)
    assert len(hist) == 3
    assert ckpt_io.latest_step(str(tmp_path)) == 3
    again, at = train_loop.resume_or_init(_state(seed=2), _state,
                                          str(tmp_path))
    assert at == 3
    _same_state(again, state)
    fresh, at = train_loop.resume_or_init(_state(seed=2), lambda: "init",
                                          str(tmp_path / "none"))
    assert (fresh, at) == ("init", 0)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train") / "g.el")
    make_graph_file(path, "rmat", scale=8, edge_factor=8, seed=21)
    return path


def test_train_loop_accepts_corpus_as_batch_source(graph):
    """train.loop duck-types a WalkCorpus straight in as batch_source."""
    cc = CorpusConfig(batch=4, seq=16, vocab_size=CFG.vocab_size, seed=3)
    corpus = WalkCorpus(open_graph(graph, device="cpu"), cc)
    seen = []

    def fake_step(state, batch):
        seen.append(batch["tokens"].clone())
        return state, {"loss": torch.tensor(0.0),
                       "grad_norm": torch.tensor(0.0)}

    class _State:
        step = torch.tensor(0, dtype=torch.int32)

    train_loop.run(_State(), fake_step, corpus, num_steps=3,
                   log=lambda s: None)
    assert len(seen) == 3
    for i, toks in enumerate(seen):
        assert torch.equal(toks, corpus.batch_at(i)["tokens"])
    # and real steps on it lower the loss of a repeated walk batch
    state, hist = train_loop.run(
        _state(), make_train_step(CFG, OptimizerConfig(
            lr=2e-3, warmup_steps=2, decay_steps=60)),
        lambda i: corpus.batch_at(0), num_steps=12, log=lambda s: None)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.9, hist


def test_launch_train_main_on_the_cpu(graph, tmp_path, capsys):
    """``--reduced --device cpu`` with ``--graph`` and ``--ckpt-dir``: the
    run checkpoints at its cadence, and a second run resumes from the last
    checkpoint and trains no step past ``--steps``."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4",
            "--seq", "16", "--graph", graph, "--ckpt-dir", ckpt,
            "--ckpt-every", "2", "--remat", "full"]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "over 4 steps" in out
    assert ckpt_io.latest_step(ckpt) == 4
    assert launch_train.main(argv[:4] + ["6"] + argv[5:]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "over 2 steps" in out
    assert launch_train.main(["--reduced", "--device", "cpu", "--steps",
                              "2", "--batch", "4", "--seq", "8",
                              "--accum", "2", "--compress-grads"]) == 0
    assert "over 2 steps" in capsys.readouterr().out
