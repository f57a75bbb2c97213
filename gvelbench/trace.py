"""Profiler helpers: device records of each profiled load, matched to their
launches by correlation id (``chip_smoke.py::traced`` / ``card_records``,
frozen here).

On the card machine a trace can lose some of its device records (kineto
counts them "out of range").  Every runtime call that put work on the
card (kernel launches, memsets, copies) is kept, and a device record
carries its launch's correlation id, so each load counts the launches left
without a record; a load that lost any is left out of the per-layer
metrics.  Idle host time on both sides of the traced work keeps records
whose device clock runs a few ms ahead of the host's inside the window.

A profiled load is a dict: ``span`` (start, end) of its host range in
microseconds of the profiler's clock, ``records`` ``[(name, start, end)]``
of the card's work that its launches put there, ``launches`` and ``lost``,
and ``gaps`` ``[(what the host was doing, seconds)]``: the card's idle
stretches inside the span, each of ``SHORT_GAP_US`` or more named by the
innermost host operation running at its middle, the shorter ones pooled.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Tuple

PAD_S = 0.05
RANGE = "gvelbench.load"
IDLE_HOST = "host code outside any traced op"
SHORT_GAP_US = 50.0
SHORT = "gaps under 50 us between launches"


@contextlib.contextmanager
def profiled(torch):
    """``torch.profiler`` over the body, padded on both sides."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PAD_S)


def is_card_work(name: str) -> bool:
    """The loader's own work on the card: kernels and memsets.  Copies wait
    on the host's memory, so they are left out."""
    return not name.startswith("Memcpy")


def _raw(prof):
    """The profile's events as ``(name, on_card, start_us, end_us,
    correlation id)``, straight from kineto (building the profiler's own
    event tree takes tens of seconds over a window)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        yield (e.name(), e.device_type() == DeviceType.CUDA, start,
               start + e.duration_ns() / 1e3, e.correlation_id())


def load_range(torch, i: int):
    """The host range that marks profiled load ``i``."""
    return torch.profiler.record_function(f"{RANGE}.{i}")


def _is_launch(name: str) -> bool:
    return name.startswith("cu") and any(
        k in name for k in ("Launch", "Memset", "Memcpy"))


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def collect(prof) -> List[Dict]:
    """The profiled loads of ``prof``, in order (see the module doc)."""
    events = list(_raw(prof))
    records = {c: (n, s, e) for n, card, s, e, c in events if card}
    cpu = [(n, s, e, c) for n, card, s, e, c in events if not card]
    ranges = sorted((x for x in cpu if x[0].startswith(RANGE + ".")),
                    key=lambda x: int(x[0].rsplit(".", 1)[1]))
    launches = sorted((x for x in cpu if _is_launch(x[0])),
                      key=lambda x: x[1])
    host_ops = sorted((x for x in cpu if not x[0].startswith(RANGE)),
                      key=lambda x: x[1])
    starts = [x[1] for x in host_ops]
    loads = []
    for _, lo, hi, _ in ranges:
        mine = [x for x in launches if lo <= x[1] <= hi]
        recs = [records[x[3]] for x in mine if x[3] in records]
        busy = union([(s, e) for _, s, e in recs])
        gaps = []
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 - g0 >= SHORT_GAP_US:
                gaps.append((_host_at(host_ops, starts, (g0 + g1) / 2),
                             (g1 - g0) / 1e6))
            elif g1 > g0:
                gaps.append((SHORT, (g1 - g0) / 1e6))
        loads.append({"span": (lo, hi), "records": recs,
                      "launches": len(mine), "lost": len(mine) - len(recs),
                      "gaps": gaps})
    return loads


def _host_at(host_ops, starts, t: float, look: int = 256) -> str:
    """The innermost of the ``look`` host ops that started last before
    ``t`` and still run at ``t``."""
    inner = None
    i = bisect.bisect_right(starts, t)
    for name, s, e, _ in host_ops[max(i - look, 0):i]:
        if t <= e and (inner is None or e - s < inner[1]):
            inner = (name, e - s)
    return IDLE_HOST if inner is None else inner[0]
