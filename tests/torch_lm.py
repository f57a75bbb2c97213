"""Helpers shared by the port's serving tests on the CPU (test_torch_serve,
test_torch_runtime) and on the card (test_torch_cuda): the margin rule
for comparing two engines' greedy token streams.

Imports no jax, so the card tests can use it; not collected by pytest.

Each logit of the port differs from the JAX package's compiled run by at
most ``COMPILED_TOL`` (tests/test_torch_models.py), so two engines' greedy
picks can part only where the top two logits lie within twice that:
``MARGIN_TOL``.
"""
import numpy as np
import torch

COMPILED_TOL = 5e-2
MARGIN_TOL = 2 * COMPILED_TOL


def f32(x) -> np.ndarray:
    """A torch tensor or a JAX array (bf16 or not) as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def record_tick_logits(eng) -> dict:
    """Wrap ``eng``'s decode step so that every tick's logits row of each
    active slot is kept under its request id (the prompt's prefill steps
    are left out): ``{rid: [logits of out[0], out[1], ...]}``."""
    rec, prefilling = {}, [False]
    decode, step_slot = eng.decode, eng._step_slot

    def in_prefill(*args):
        prefilling[0] = True
        try:
            return step_slot(*args)
        finally:
            prefilling[0] = False

    def recorded(*args):
        nxt, logits, caches = decode(*args)
        if not prefilling[0]:
            lg = f32(logits)
            for s, req in enumerate(eng.slots):
                if req is not None:
                    rec.setdefault(req.rid, []).append(lg[s])
        return nxt, logits, caches

    eng._step_slot, eng.decode = in_prefill, recorded
    return rec


def top2_margin(logits: np.ndarray) -> float:
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def assert_streams_agree(got: dict, want: dict, want_logits: dict,
                         tol: float = MARGIN_TOL) -> int:
    """``{rid: tokens}`` of two engines: per request, equal streams, or at
    the first differing step the reference's top-2 margin lies below
    ``tol``.  Returns how many requests' streams differ."""
    assert sorted(got) == sorted(want)
    parted = 0
    for rid in want:
        a, b = got[rid], want[rid]
        assert len(a) == len(b), rid
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            margin = top2_margin(want_logits[rid][diff[0]])
            assert margin < tol, (rid, diff[0], margin)
            parted += 1
    return parted
