"""Measured block-geometry autotuning for the streaming loader.

The port of ``repro/core/tune.py``.  GVEL's Figure 2 sweeps the block size
and finds the throughput knee by measurement: the right ``beta`` (owned
bytes per block) and ``batch_blocks`` (blocks per parse launch) depend on
the host's copy and staging rates and on the card, not on anything that
can be derived.  So:

* :func:`run_sweep` stages a synthetic in-memory edgelist through the
  loader's own streaming step (``StagingArena``, pinned on CUDA ->
  ``_DeviceFeed`` -> the fused ``parse_accumulate`` kernel) for every
  ``beta x batch_blocks`` pair and times it on the load's device, after
  one warm-up pass per pair;
* :func:`tuned_geometry` keeps the winner in a JSON profile
  (``$REPRO_TUNE_CACHE`` or ``~/.cache/repro/tune.json``) keyed by
  :func:`host_key`, the port's :func:`~.env.fingerprint` of the device,
  so the sweep runs once per host and device, not once per process;
* the loader asks only when told to (``open_graph(path, tune=True)``,
  ``LoadOptions(tune=True)``); an explicit ``beta``/``batch_blocks``
  always wins.

The profile's schema and version are the reference's; the keys differ
(the port's fingerprint names torch, CUDA and the card), so the two
packages never share a slot.  Delete the file (or pass ``refresh=True``)
to measure again after a hardware or software change.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

PROFILE_VERSION = 1
DEFAULT_BETAS = (64 * 1024, 256 * 1024, 1024 * 1024)
DEFAULT_BATCH_BLOCKS = (2, 4, 8)
SAMPLE_BYTES = 4 * 1024 * 1024
_ENV_CACHE = "REPRO_TUNE_CACHE"


def host_key(device=None) -> str:
    """Profile key: the platform and card the geometry was measured on
    (:func:`~.env.fingerprint`; ``device=None`` means CUDA when present)."""
    from .env import fingerprint
    return fingerprint(device)


def cache_path() -> str:
    env = os.environ.get(_ENV_CACHE)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro",
                        "tune.json")


def clear_cache(path: Optional[str] = None) -> bool:
    """Delete the profile file (the next tuned load measures again).
    Returns whether a file was removed."""
    p = path or cache_path()
    try:
        os.remove(p)
        return True
    except FileNotFoundError:
        return False


def synthetic_sample(nbytes: int = SAMPLE_BYTES, *, weighted: bool = False,
                     seed: int = 0) -> np.ndarray:
    """An in-memory uniform edgelist of about ``nbytes`` text bytes, the
    sweep's workload (the parse's cost follows the bytes and the line
    shape far more than the graph's structure); the reference's bytes for
    the same seed."""
    rng = np.random.default_rng(seed)
    # ~"123456 654321[ 0.123]\n": lines from the line width
    width = 14 + (6 if weighted else 0)
    n = max(nbytes // width, 16)
    src = rng.integers(1, 999_999, n)
    dst = rng.integers(1, 999_999, n)
    if weighted:
        w = (rng.random(n) * 9).round(3)
        lines = [f"{s} {d} {x}" for s, d, x in zip(src, dst, w)]
    else:
        lines = [f"{s} {d}" for s, d in zip(src, dst)]
    return np.frombuffer(("\n".join(lines) + "\n").encode(), np.uint8)


def measure_geometry(data: np.ndarray, beta: int, batch_blocks: int, *,
                     weighted: bool = False, base: int = 1,
                     overlap: int = 64, repeat: int = 2,
                     device=None) -> float:
    """Seconds for one whole streaming pass over ``data`` at this geometry
    on ``device`` (default CUDA): the least of ``repeat`` passes after one
    warm-up, each between two synchronizations of the card."""
    from .blocks import MemoryBlockSource, plan_blocks
    from .env import resolve_device
    from .loader import _parse_span

    dev = resolve_device(device)
    plan = plan_blocks(len(data), beta=beta, overlap=overlap)
    cap = plan.num_blocks * plan.edge_cap
    source = MemoryBlockSource(data)

    def one_pass() -> None:
        _parse_span(source, plan, 0, plan.num_blocks, weighted=weighted,
                    base=base, batch_blocks=batch_blocks, cap=cap,
                    device=dev, describe="tune sample", prefetch=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    one_pass()                                    # warm-up
    best = float("inf")
    for _ in range(max(repeat, 1)):
        t0 = time.perf_counter()
        one_pass()
        best = min(best, time.perf_counter() - t0)
    return best


def run_sweep(data: Optional[np.ndarray] = None, *,
              betas: Iterable[int] = DEFAULT_BETAS,
              batch_blocks: Iterable[int] = DEFAULT_BATCH_BLOCKS,
              weighted: bool = False, base: int = 1, overlap: int = 64,
              sample_bytes: int = SAMPLE_BYTES, repeat: int = 2,
              device=None) -> List[Dict]:
    """Measure every ``beta x batch_blocks`` pair on ``device``; rows
    sorted fastest first.  ``data=None`` measures
    :func:`synthetic_sample`."""
    if data is None:
        data = synthetic_sample(sample_bytes, weighted=weighted)
    rows = []
    for beta in betas:
        if beta <= overlap:
            continue                      # plan_blocks would refuse it
        for bb in batch_blocks:
            secs = measure_geometry(data, int(beta), int(bb),
                                    weighted=weighted, base=base,
                                    overlap=overlap, repeat=repeat,
                                    device=device)
            rows.append({"beta": int(beta), "batch_blocks": int(bb),
                         "seconds": round(secs, 6),
                         "mb_per_s": round(len(data) / 1e6 / secs, 3)})
    if not rows:
        raise ValueError("empty sweep grid (every beta <= overlap?)")
    rows.sort(key=lambda r: r["seconds"])
    return rows


def best_geometry(rows: List[Dict]) -> Dict[str, int]:
    top = min(rows, key=lambda r: r["seconds"])
    return {"beta": top["beta"], "batch_blocks": top["batch_blocks"]}


def _load_profile(path: str) -> Dict:
    try:
        with open(path) as f:
            prof = json.load(f)
        if isinstance(prof, dict) and prof.get("version") == PROFILE_VERSION:
            return prof
    except (OSError, ValueError):
        pass                               # absent or corrupt: measure again
    return {"version": PROFILE_VERSION, "hosts": {}}


def _save_profile(path: str, prof: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(prof, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)                  # atomic: readers never see half


def _slot_name(weighted: bool, shards: int) -> str:
    """Profile slot: weighted or not, with a ``_d{shards}`` suffix for the
    sharded load (each shard streams about 1/d of the file, so its knee
    sits elsewhere than one stream's)."""
    slot = "weighted" if weighted else "unweighted"
    if shards > 1:
        slot = f"{slot}_d{int(shards)}"
    return slot


def save_geometry(rows: List[Dict], *, weighted: bool = False,
                  shards: int = 1, path: Optional[str] = None,
                  device=None) -> Dict[str, int]:
    """Keep a sweep's winner (and its rows) in this host's profile slot and
    return the winner.  The profile is read again just before the atomic
    replace, so a process keeping another slot at the same time is not
    overwritten."""
    p = path or cache_path()
    best = best_geometry(rows)
    prof = _load_profile(p)
    prof["hosts"].setdefault(host_key(device), {})[
        _slot_name(weighted, shards)] = {
        **best, "sweep": rows, "measured_at": int(time.time())}
    _save_profile(p, prof)
    return best


def tuned_geometry(*, weighted: bool = False, shards: int = 1,
                   refresh: bool = False, device=None,
                   **sweep_kw) -> Dict[str, int]:
    """The measured ``{"beta": ..., "batch_blocks": ...}`` for this host and
    ``device``: read from the profile, or on a miss (or ``refresh=True``)
    measured by one :func:`run_sweep` on ``device`` and kept.  Weighted and
    unweighted parses have their own slots, and so does each shard count
    (``shards`` > 1 measures on a sample of about 1/d the size)."""
    path = cache_path()
    key, slot = host_key(device), _slot_name(weighted, shards)
    entry = _load_profile(path)["hosts"].get(key, {}).get(slot)
    if entry and not refresh:
        return {"beta": int(entry["beta"]),
                "batch_blocks": int(entry["batch_blocks"])}
    if shards > 1:
        sweep_kw.setdefault(
            "sample_bytes", max(SAMPLE_BYTES // int(shards), 256 * 1024))
    rows = run_sweep(weighted=weighted, device=device, **sweep_kw)
    return save_geometry(rows, weighted=weighted, shards=shards, path=path,
                         device=device)
