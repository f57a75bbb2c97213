"""The port's autotuner held against the JAX package's on the CPU
(``tests/test_fused_loader.py``'s tuner cases and
``tests/test_sharded_stream.py::test_tuned_shard_slot``).

Each test points ``REPRO_TUNE_CACHE`` at its own ``tmp_path`` and either
seeds the profile, replaces ``run_sweep``, or measures a tiny real grid, so
no test sweeps the default grid.  The two packages key their profiles by
their own fingerprints, so a profile is seeded under each package's key.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import load_csr as j_load_csr
from repro.core import open_graph as j_open
from repro.core import tune as jtune
from repro.core.loader import LoadOptions as JOptions
from repro.core.loader import resolve_tuned as j_resolve
from repro_torch.core import load_csr, load_edgelist, open_graph, tune
from repro_torch.core.loader import LoadOptions, resolve_tuned

import torch_serving as ts

CPU = torch.device("cpu")
ROWS = [{"beta": 1024, "batch_blocks": 2, "seconds": 0.5, "mb_per_s": 1.0},
        {"beta": 2048, "batch_blocks": 4, "seconds": 0.9, "mb_per_s": 0.5}]


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    return path


def _seed(path, beta=4096, batch_blocks=3):
    """One profile with both packages' slots at the same geometry."""
    slots = {"unweighted": {"beta": beta, "batch_blocks": batch_blocks,
                            "sweep": []},
             "weighted": {"beta": beta * 2, "batch_blocks": batch_blocks,
                          "sweep": []}}
    prof = {"version": tune.PROFILE_VERSION,
            "hosts": {tune.host_key(CPU): slots, jtune.host_key(): slots}}
    with open(path, "w") as f:
        json.dump(prof, f)


def _no_sweep(*a, **k):
    pytest.fail("the sweep ran on a profile hit")


def test_profile_constants_match_reference():
    assert tune.PROFILE_VERSION == jtune.PROFILE_VERSION
    assert tune.DEFAULT_BETAS == jtune.DEFAULT_BETAS
    assert tune.DEFAULT_BATCH_BLOCKS == jtune.DEFAULT_BATCH_BLOCKS
    assert tune.SAMPLE_BYTES == jtune.SAMPLE_BYTES
    assert tune._ENV_CACHE == jtune._ENV_CACHE == "REPRO_TUNE_CACHE"


def test_host_key_is_the_port_fingerprint():
    from repro_torch.core import env
    assert tune.host_key(CPU) == env.fingerprint(CPU)
    assert tune.host_key(CPU) != jtune.host_key()   # never a shared slot
    assert "torch" in tune.host_key(CPU)


def test_cache_path_and_clear(cache, monkeypatch):
    assert tune.cache_path() == cache == jtune.cache_path()
    assert tune.clear_cache() is False
    tune.save_geometry(ROWS, device=CPU)
    assert os.path.exists(cache)
    assert tune.clear_cache() is True and not os.path.exists(cache)
    monkeypatch.delenv("REPRO_TUNE_CACHE")
    assert tune.cache_path() == jtune.cache_path()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nbytes,seed", [(48 * 1024, 0), (5000, 3),
                                         (10, 1)])
def test_synthetic_sample_is_the_reference_bytes(weighted, nbytes, seed):
    got = tune.synthetic_sample(nbytes, weighted=weighted, seed=seed)
    want = jtune.synthetic_sample(nbytes, weighted=weighted, seed=seed)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_slot_names_match_reference(weighted, shards):
    assert tune._slot_name(weighted, shards) == \
        jtune._slot_name(weighted, shards)


def test_tuned_geometry_hits_cache_without_sweeping(cache, monkeypatch):
    _seed(cache)
    monkeypatch.setattr(tune, "run_sweep", _no_sweep)
    assert tune.tuned_geometry(weighted=False, device=CPU) == {
        "beta": 4096, "batch_blocks": 3}
    assert tune.tuned_geometry(weighted=True, device=CPU) == {
        "beta": 8192, "batch_blocks": 3}


def test_tuned_geometry_sweeps_and_persists_on_miss(cache, monkeypatch):
    calls = []
    monkeypatch.setattr(tune, "run_sweep",
                        lambda *a, **k: calls.append(k) or list(ROWS))
    got = tune.tuned_geometry(weighted=False, device=CPU)
    assert got == {"beta": 1024, "batch_blocks": 2}
    assert calls == [{"weighted": False, "device": CPU}]
    saved = json.load(open(cache))
    entry = saved["hosts"][tune.host_key(CPU)]["unweighted"]
    assert entry["beta"] == 1024 and entry["sweep"] == ROWS
    monkeypatch.setattr(tune, "run_sweep", _no_sweep)
    assert tune.tuned_geometry(weighted=False, device=CPU) == got
    # refresh measures again
    monkeypatch.setattr(tune, "run_sweep", lambda *a, **k: list(ROWS[::-1]))
    assert tune.tuned_geometry(weighted=False, device=CPU,
                               refresh=True) == got


def test_sharded_slot_samples_a_shards_share(cache, monkeypatch):
    seen = {}
    for mod, kw in ((tune, {"device": CPU}), (jtune, {})):
        got = []
        monkeypatch.setattr(mod, "run_sweep",
                            lambda *a, _g=got, **k: _g.append(k) or list(ROWS))
        mod.tuned_geometry(weighted=True, shards=8, **kw)
        seen[mod.__name__] = got[0]["sample_bytes"]
    assert seen["repro_torch.core.tune"] == seen["repro.core.tune"] \
        == max(tune.SAMPLE_BYTES // 8, 256 * 1024)


def test_profile_written_by_the_port_has_the_reference_schema(
        cache, tmp_path):
    tune.save_geometry(ROWS, weighted=True, shards=2, device=CPU)
    ref_path = str(tmp_path / "ref.json")
    jtune.save_geometry(ROWS, weighted=True, shards=2, path=ref_path)
    got, want = json.load(open(cache)), json.load(open(ref_path))
    assert set(got) == set(want) == {"version", "hosts"}
    assert got["version"] == want["version"]
    (gslots,), (wslots,) = got["hosts"].values(), want["hosts"].values()
    assert set(gslots) == set(wslots) == {"weighted_d2"}
    g, w = gslots["weighted_d2"], wslots["weighted_d2"]
    assert set(g) == set(w) == {"beta", "batch_blocks", "sweep",
                                "measured_at"}
    assert {k: g[k] for k in ("beta", "batch_blocks", "sweep")} == \
        {k: w[k] for k in ("beta", "batch_blocks", "sweep")}
    # the reference reads the port's file (under its own key it misses)
    assert jtune._load_profile(cache) == got


def test_corrupt_or_old_profile_is_measured_again(cache, monkeypatch):
    monkeypatch.setattr(tune, "run_sweep", lambda *a, **k: list(ROWS))
    for body in ("{not json", json.dumps({"version": 0, "hosts": {}})):
        with open(cache, "w") as f:
            f.write(body)
        assert tune._load_profile(cache) == jtune._load_profile(cache) == \
            {"version": tune.PROFILE_VERSION, "hosts": {}}
        assert tune.tuned_geometry(device=CPU) == {"beta": 1024,
                                                   "batch_blocks": 2}


def test_run_sweep_measures_a_real_grid():
    data = tune.synthetic_sample(48 * 1024)
    rows = tune.run_sweep(data, betas=(4096, 16384), batch_blocks=(2,),
                          repeat=1, device=CPU)
    assert len(rows) == 2
    assert rows == sorted(rows, key=lambda r: r["seconds"])
    assert all(r["seconds"] > 0 and r["mb_per_s"] > 0 for r in rows)
    assert set(rows[0]) == {"beta", "batch_blocks", "seconds", "mb_per_s"}
    assert tune.best_geometry(rows)["beta"] in (4096, 16384)
    with pytest.raises(ValueError, match="empty sweep grid"):
        tune.run_sweep(data, betas=(64,), batch_blocks=(2,), device=CPU)


def test_measure_geometry_needs_a_card_unless_told_cpu():
    data = tune.synthetic_sample(4096)
    assert tune.measure_geometry(data, 1024, 2, repeat=1, device=CPU) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune.measure_geometry(data, 1024, 2, repeat=1)


def test_resolve_tuned_fills_unpinned_geometry(cache, monkeypatch):
    _seed(cache)
    monkeypatch.setattr(tune, "run_sweep", _no_sweep)
    for kw, ref_kw in (({}, {}), ({"beta": 777216}, {"beta": 777216}),
                       ({"batch_blocks": 5}, {"batch_blocks": 5})):
        got = resolve_tuned(LoadOptions(engine="device", tune=True,
                                        device=CPU, engine_kw=kw))
        want = j_resolve(JOptions(engine="device", tune=True,
                                  engine_kw=ref_kw))
        assert got.engine_kw == want.engine_kw
    # off, or an engine without block geometry: untouched
    off = LoadOptions(engine="device", device=CPU)
    assert resolve_tuned(off) is off
    snap = LoadOptions(engine="snapshot", tune=True, device=CPU)
    assert resolve_tuned(snap).engine_kw == {}
    pinned = LoadOptions(engine="device", tune=True, device=CPU,
                         engine_kw={"beta": 1024, "batch_blocks": 2})
    assert resolve_tuned(pinned) is pinned


def test_tuned_shard_slot(cache):
    tune.save_geometry([{"beta": 4096, "batch_blocks": 2, "seconds": 0.5,
                         "mb_per_s": 1.0}], shards=4, device=CPU)
    tune.save_geometry([{"beta": 65536, "batch_blocks": 8, "seconds": 0.4,
                         "mb_per_s": 1.0}], device=CPU)
    slots = json.load(open(cache))["hosts"][tune.host_key(CPU)]
    assert set(slots) == {"unweighted", "unweighted_d4"}
    opts = LoadOptions(engine="device", weighted=False, tune=True,
                       device=CPU)
    assert resolve_tuned(opts).engine_kw["beta"] == 65536
    assert resolve_tuned(opts, shards=4).engine_kw["beta"] == 4096
    pinned = opts.replace(engine_kw={"beta": 1024, "batch_blocks": 2})
    assert resolve_tuned(pinned, shards=4).engine_kw["beta"] == 1024


@pytest.mark.parametrize("weighted", [False, True])
def test_tuned_load_matches_reference(cache, monkeypatch, tmp_path,
                                      weighted):
    _seed(cache, beta=1024, batch_blocks=2)
    monkeypatch.setattr(tune, "run_sweep", _no_sweep)
    monkeypatch.setattr(jtune, "run_sweep", _no_sweep)
    path, v, oracle = ts.text_file(tmp_path, "t", seed=8, v=60, e=700,
                                   weighted=weighted)
    got = load_csr(path, device="cpu", weighted=weighted, num_vertices=v,
                   tune=True)
    want = j_load_csr(path, engine="device", weighted=weighted,
                      num_vertices=v, tune=True)
    assert ts.same_csr(got, want) and ts.same_csr(got, oracle)
    src = open_graph(path, device="cpu", weighted=weighted, num_vertices=v,
                     tune=True)
    assert src.options.tune
    assert ts.same_csr(src.csr(), oracle)
    assert ts.same_csr(src.csr(), j_open(path, engine="device",
                                         weighted=weighted, num_vertices=v,
                                         tune=True).csr())
    (s, d, w, total), cap = src.stream()
    assert int(total) == 700
    el = load_edgelist(path, device="cpu", weighted=weighted, tune=True)
    assert el.num_edges == 700


def test_tune_geometry_reaches_the_stream(cache, monkeypatch, tmp_path):
    """The profile's beta sets the plan (its edge capacity shows it), and
    the tuned CSR equals the untuned one bitwise."""
    _seed(cache, beta=1024, batch_blocks=2)
    monkeypatch.setattr(tune, "run_sweep", _no_sweep)
    path, v, _ = ts.text_file(tmp_path, "t", e=900)
    tuned = open_graph(path, device="cpu", tune=True)
    plain = open_graph(path, device="cpu")
    (_, _, _, _), cap_tuned = tuned.stream()
    (_, _, _, _), cap_plain = plain.stream()
    size = os.path.getsize(path)
    assert cap_tuned == -(-size // 1024) * ((64 + 1024) // 4 + 2)
    assert cap_plain != cap_tuned
    assert ts.same_csr(tuned.csr(), plain.csr())
