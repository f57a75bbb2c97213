"""The port's serving engine (``repro_torch.serve``) on the CPU: twins of
tests/test_serve.py's seven scheduling tests, and the same requests through
both packages' engines.

The model is the JAX package's ``init_params(key(3))`` draw of the reduced
phi4-mini (the reference tests' weights), carried over with
``params_from_jax``.  Token streams of the two engines must agree; where a
request's streams first differ, the JAX logits' top-2 margin at that step
must be below ``torch_lm.MARGIN_TOL`` (the rule and its reason are in
tests/torch_lm.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.models import init_params as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import reduced_config
from repro_torch.models import (forward_decode, forward_prefill,
                                params_from_jax)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.step import make_decode_step, make_prefill_step
from torch_lm import assert_streams_agree, f32, record_tick_logits

CFG = reduced_config("phi4-mini-3.8b")


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.key(3), jreduced("phi4-mini-3.8b"))


@pytest.fixture(scope="module")
def setup(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CFG,
                           device="cpu")


def _engine(model, **kw):
    return ServeEngine(CFG, model, device="cpu", **kw)


def test_engine_completes_all_requests(setup):
    eng = _engine(setup, batch=4, max_seq=64)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, CFG.vocab_size, 5).astype(np.int32), 6)
            for i in range(7)]   # 7 requests > 4 slots -> continuous batching
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.done and len(r.out) == 6


def test_engine_greedy_matches_manual_decode(setup):
    """Single request through the engine == manual prefill+decode chain."""
    model = setup
    prompt = np.asarray([5, 17, 3, 42], np.int32)
    eng = _engine(model, batch=2, max_seq=32)
    req = Request(0, prompt, 4)
    eng.submit(req)
    eng.run()

    with torch.inference_mode():
        lg, caches = forward_prefill(
            model, {"tokens": torch.from_numpy(prompt[None])}, CFG, max_seq=32)
        tok = int(torch.argmax(lg[0]))
        # the engine's prefill is step-wise: compare from its first token
        pos = len(prompt)
        toks = [tok]
        for _ in range(3):
            lg2, caches = forward_decode(
                model, {"token": torch.tensor([tok], dtype=torch.int32),
                        "pos": torch.tensor([pos], dtype=torch.int32)},
                caches, CFG, max_seq=32)
            tok = int(torch.argmax(lg2[0]))
            pos += 1
            toks.append(tok)
    assert req.out == toks


def test_engine_respects_max_seq(setup):
    eng = _engine(setup, batch=2, max_seq=16)
    req = Request(0, np.asarray([1, 2, 3], np.int32), 100)
    eng.submit(req)
    eng.run()
    assert req.done and len(req.out) <= 13


def test_queue_never_drops_fifo_per_slot(setup):
    """Many more requests than slots: every request is admitted (none
    dropped at tick boundaries) and completion order per slot is FIFO."""
    eng = _engine(setup, batch=3, max_seq=64)
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(0, CFG.vocab_size, 4).astype(np.int32),
                    int(rng.integers(2, 6)))
            for i in range(11)]            # 11 requests > 3 slots
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert not eng.queue and all(s is None for s in eng.slots)
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert sorted(r.rid for r in eng.completed) == list(range(11))
    by_slot = {}
    for r in eng.completed:
        by_slot.setdefault(r.slot, []).append(r.rid)
    for slot, rids in by_slot.items():
        assert rids == sorted(rids), (slot, rids)


def test_slot_freed_and_refilled_same_tick(setup):
    """A slot that completes on tick t admits the next queued request on
    tick t (continuous batching), not t+1."""
    eng = _engine(setup, batch=1, max_seq=32)
    first = Request(0, np.asarray([1, 2], np.int32), 1)
    second = Request(1, np.asarray([3, 4], np.int32), 1)
    eng.submit(first)
    eng.submit(second)
    eng.step()                             # first completes this tick...
    assert first.done
    assert eng.slots[0] is second          # ...second already admitted
    assert not eng.queue


def test_max_active_caps_admission(setup):
    eng = _engine(setup, batch=4, max_seq=32)
    eng.max_active = 2
    reqs = [Request(i, np.asarray([1, 2], np.int32), 3) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    while eng.queue or any(s is not None for s in eng.slots):
        eng.step()
        assert sum(1 for s in eng.slots if s is not None) <= 2
    assert all(r.done for r in reqs)
    assert {r.slot for r in reqs} <= {0, 1}


def test_run_max_ticks_raises_instead_of_dropping(setup):
    eng = _engine(setup, batch=1, max_seq=64)
    for i in range(4):
        eng.submit(Request(i, np.asarray([1, 2], np.int32), 8))
    with pytest.raises(RuntimeError, match="pending"):
        eng.run(max_ticks=2)
    assert eng.queue or any(s is not None for s in eng.slots)  # kept, not lost
    eng.run()                              # a fresh drain finishes them
    assert len(eng.completed) == 4


# ---- the two packages' engines on the same requests ----------------------------

def test_engine_streams_match_the_reference(setup, jparams):
    """Eleven walk-like requests (prompts of 2-9 tokens, 1-9 new tokens)
    through three slots of both engines: same token streams under the
    margin rule, same slots, same completion order."""
    rng = np.random.default_rng(11)
    specs = [(rng.integers(0, CFG.vocab_size, int(rng.integers(2, 10)))
              .astype(np.int32), int(rng.integers(1, 10))) for _ in range(11)]
    jeng = JEngine(jreduced("phi4-mini-3.8b"), jparams, batch=3, max_seq=48)
    eng = _engine(setup, batch=3, max_seq=48)
    jlogits = record_tick_logits(jeng)
    record_tick_logits(eng)
    for i, (prompt, new) in enumerate(specs):
        jeng.submit(JRequest(i, prompt, new))
        eng.submit(Request(i, prompt, new))
    assert eng.run() == jeng.run()
    assert [r.rid for r in eng.completed] == [r.rid for r in jeng.completed]
    assert [r.slot for r in eng.completed] == [r.slot for r in jeng.completed]
    assert_streams_agree({r.rid: r.out for r in eng.completed},
                         {r.rid: r.out for r in jeng.completed}, jlogits)


def test_steps_and_first_index_argmax(setup):
    """``make_prefill_step`` is ``forward_prefill`` in inference mode, and
    the decode step's greedy pick is the first index of a tied maximum, as
    ``jnp.argmax``'s (a tie built at the served vocab size)."""
    prompt = torch.tensor([[5, 17, 3]], dtype=torch.int32)
    lg, caches = make_prefill_step(CFG, 16)(setup, {"tokens": prompt})
    with torch.inference_mode():
        want, _ = forward_prefill(setup, {"tokens": prompt}, CFG, 16)
    assert torch.equal(lg, want) and len(caches) == CFG.num_layers
    assert torch.is_inference(lg)

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(8, 200064)).astype(np.float32)
    for row in range(8):
        logits[row, rng.choice(200064, 2, replace=False)] = 9.0
    t = torch.from_numpy(logits).to(torch.bfloat16)
    got = torch.argmax(t, dim=-1)
    assert got.tolist() == np.asarray(jnp.argmax(
        jnp.asarray(logits).astype(jnp.bfloat16), axis=-1)).tolist()
    assert got.tolist() == [int(np.flatnonzero(r == 9.0)[0]) for r in logits]

    nxt, lg2, _ = make_decode_step(CFG, 16)(
        setup, caches, {"token": torch.tensor([7], dtype=torch.int32),
                        "pos": torch.tensor([3], dtype=torch.int32)})
    assert nxt.dtype == torch.int32
    assert int(nxt[0]) == int(np.argmax(f32(lg2)[0]))


def test_engine_needs_cuda_unless_told_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(CFG, setup, batch=2, max_seq=8)
