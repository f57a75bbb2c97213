"""The port's threefry PRNG, random walks and prefetch pipeline held
against the JAX package, on the CPU.

``repro_torch.data.prng`` must reproduce ``jax.random`` (threefry2x32,
partitionable counts, 32-bit ints) bit for bit, because the reference's
walks are pinned bitwise; so must ``repro_torch.data.walks`` against
``repro.data.walks``.  CSRs are made with numpy from a seed and handed to
both packages.
"""
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data import walks as jwalks
from repro_torch.core import CSR
from repro_torch.core.faults import StageTimeout
from repro_torch.data import prng, walks
from repro_torch.data.pipeline import Prefetcher

SEEDS = (0, 99, -1, 2**31 - 1)


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _csr(rng, v, e, dead=()):
    """Random CSR (int32 numpy arrays); vertices in ``dead`` get no
    out-edges."""
    if e == 0:
        return np.zeros(v + 1, np.int32), np.zeros(0, np.int32)
    alive = np.setdiff1d(np.arange(v), dead)
    src = rng.choice(alive, e)
    off = np.concatenate([[0], np.cumsum(np.bincount(src, minlength=v))])
    return off.astype(np.int32), rng.integers(0, v, e).astype(np.int32)


class _Cfg:
    vocab_size = 64


# -- prng --------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bits_match_jax(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    assert np.array_equal(_kd(jk), tk.numpy())
    for d in (0, 1, 0x7FFFFFFF, -3):
        assert np.array_equal(_kd(jax.random.fold_in(jk, jnp.int32(d))),
                              prng.fold_in(tk, d).numpy())
    for n in (1, 2, 5):
        assert np.array_equal(_kd(jax.random.split(jk, n)),
                              prng.split(tk, n).numpy())
    assert int(jax.random.bits(jk, (), jnp.uint32)) == \
        int(prng.random_bits(tk))
    assert np.array_equal(
        np.asarray(jax.random.bits(jk, (6,), jnp.uint32)).astype(np.int64),
        prng.random_bits(tk, 6).numpy())


@pytest.mark.parametrize("lo,hi", [
    (0, 1), (0, 2), (0, 7), (0, 2**31 - 1),      # spans 1, 2, 7, 2**31 - 1
    (5, 5), (9, 3),                               # hi <= lo -> lo
    (0, 65536), (0, 65537), (-7, 100000),        # around the 2**16 wrap
    (-2**31, 2**31 - 1),                          # span wraps in int32
])
def test_randint_matches_jax(lo, hi):
    for seed in SEEDS:
        jk, tk = jax.random.key(seed), prng.key(seed)
        want = int(jax.random.randint(jk, (), lo, hi, jnp.int32))
        assert int(prng.randint(tk, lo, hi)) == want


def test_vectorised_fold_in_and_randint_match_vmap():
    ids = np.arange(-4, 60, dtype=np.int32)
    his = (np.arange(len(ids), dtype=np.int32) * 997) % 70000
    jks = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(
        jnp.asarray(ids))
    tks = prng.fold_in(prng.key(7), torch.from_numpy(ids))
    assert np.array_equal(_kd(jks), tks.numpy())
    want = jax.vmap(lambda k, h: jax.random.randint(k, (), 0, h, jnp.int32))(
        jks, jnp.asarray(his))
    got = prng.randint(tks, 0, torch.from_numpy(his))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- walks -------------------------------------------------------------------

@pytest.mark.parametrize("v,e,dead", [
    (40, 300, ()),              # a plain random CSR
    (30, 120, (0, 3, 4, 17)),   # dead ends self-loop
    (12, 0, ()),                # edgeless: every vertex self-loops
])
@pytest.mark.parametrize("walk_offset", [0, 37])
def test_random_walks_match_reference(v, e, dead, walk_offset):
    off, tgt = _csr(np.random.default_rng(v + e), v, e, dead)
    want = jwalks.random_walks(jnp.asarray(off), jnp.asarray(tgt),
                               jax.random.key(3), num_walks=16, length=7,
                               num_vertices=v, walk_offset=walk_offset)
    got = walks.random_walks(torch.from_numpy(off.astype(np.int64)),
                             torch.from_numpy(tgt), prng.key(3),
                             num_walks=16, length=7, num_vertices=v,
                             walk_offset=walk_offset)
    assert got.dtype == torch.int32 and got.shape == (16, 7)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_walk_keys_and_walk_from_match_reference():
    off, tgt = _csr(np.random.default_rng(5), 25, 90, dead=(2, 9))
    ids = np.arange(100, 112, dtype=np.int32)
    jkeys = jwalks.walk_keys(jax.random.key(11), ids)
    tkeys = walks.walk_keys(prng.key(11), torch.from_numpy(ids))
    assert np.array_equal(_kd(jkeys), tkeys.numpy())
    starts = np.array([0, 2, 9, 24, 5, 5, 1, 3, 9, 2, 11, 0], np.int32)
    want = jwalks.walk_from(jnp.asarray(off), jnp.asarray(tgt), jkeys,
                            jnp.asarray(starts), length=9)
    got = walks.walk_from(torch.from_numpy(off), torch.from_numpy(tgt),
                          tkeys, torch.from_numpy(starts), length=9)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0].tolist() == starts.tolist()


def test_walk_batch_matches_reference():
    off, tgt = _csr(np.random.default_rng(8), 50, 400)
    csr = CSR(torch.from_numpy(off.astype(np.int64)), torch.from_numpy(tgt),
              None, 50)
    ref_csr = CSR(off, tgt, None, 50)
    for step, wo in ((0, 0), (3, 5)):
        want = jwalks.walk_batch(ref_csr, _Cfg, 6, 5, step, seed=4,
                                 walk_offset=wo)
        got = walks.walk_batch(csr, _Cfg, 6, 5, step, seed=4, walk_offset=wo)
        for name in ("tokens", "labels"):
            assert got[name].shape == (6, 5)
            assert np.array_equal(got[name].numpy(), np.asarray(want[name]))


def test_batch_split_invariance():
    off, tgt = _csr(np.random.default_rng(9), 64, 500)
    o, t = torch.from_numpy(off.astype(np.int64)), torch.from_numpy(tgt)
    k = prng.key(21)
    whole = walks.random_walks(o, t, k, num_walks=10, length=6,
                               num_vertices=64)
    parts = [walks.random_walks(o, t, k, num_walks=5, length=6,
                                num_vertices=64, walk_offset=wo)
             for wo in (0, 5)]
    assert torch.equal(whole, torch.cat(parts))


# -- pipeline ----------------------------------------------------------------

def test_prefetcher_orders_moves_and_propagates_failures():
    def source(step):
        if step == 3:
            raise KeyError("boom")
        return {"x": torch.full((2,), step)}

    pf = Prefetcher(source, start_step=1, lookahead=2, device="cpu")
    try:
        assert pf.get(expect_step=1)["x"].tolist() == [1, 1]
        assert pf.get(expect_step=2)["x"].device.type == "cpu"
        with pytest.raises(KeyError, match="boom"):
            pf.get(expect_step=3)
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_builds_each_step_once_behind_a_slow_consumer():
    calls = []

    def source(step):
        calls.append(step)
        return {"x": torch.full((2,), step)}

    pf = Prefetcher(source, lookahead=1, device="cpu")
    try:
        got = []
        for step in range(3):
            time.sleep(0.5)         # the queue stays full past a put timeout
            got.append(int(pf.get(expect_step=step)["x"][0]))
    finally:
        pf.close()
    assert got == [0, 1, 2]
    assert calls == sorted(set(calls)) and calls[:3] == [0, 1, 2]


def test_prefetcher_watchdog_raises_stage_timeout():
    release = threading.Event()

    def stuck(step):
        release.wait(5.0)
        return {}

    pf = Prefetcher(stuck, timeout=0.2)
    t0 = time.perf_counter()
    try:
        with pytest.raises(StageTimeout):
            pf.get()
        assert time.perf_counter() - t0 < 3.0
    finally:
        release.set()
        pf.close()
