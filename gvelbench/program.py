"""The port's own record of each profiled load, for the readers of
``program_span`` and ``program_counter`` metrics.

Under the profiler the port records every load it starts
(``repro_torch.core.tracing``): spans of the calling thread and of the
prefetch thread, on ``time.time_ns()``, and the load's counters.
:func:`loads` takes those records once (``tracing.take()``) and puts each
under ``program`` in the kept profiled load whose host span it overlaps
most: both clocks are Unix time, nanoseconds there and microseconds in a
load's ``span``.  A load that lost a device record is not kept
(``RunData.loads``), so its record goes with it.  A load with no record
gets ``program`` None; a port without the module records nothing, and the
readers then read nothing.

A load's ``program`` is ``{"id", "spans": [{"name", "start_ns", "end_ns",
"thread", "parent", "span"}], "counters": {...}}``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from . import trace


def _take() -> List[Dict]:
    try:
        from repro_torch.core import tracing
    except ImportError:
        return []
    return tracing.take()


def attach(loads: List[Dict], records: Iterable[Dict]) -> None:
    """Each record under ``program`` of the load it overlaps most; records
    that overlap none are dropped, and loads left without one get None."""
    for rec in records:
        if not rec["spans"]:
            continue
        lo = min(s["start_ns"] for s in rec["spans"]) / 1e3
        hi = max(s["end_ns"] for s in rec["spans"]) / 1e3
        best, most = None, 0.0
        for ld in loads:
            a, b = ld["span"]
            over = min(b, hi) - max(a, lo)
            if over > most:
                best, most = ld, over
        if best is None:
            continue
        prog = best.get("program")
        if prog is None:
            best["program"] = {"id": rec["id"], "spans": list(rec["spans"]),
                               "counters": dict(rec["counters"])}
        else:
            prog["spans"] += rec["spans"]
            for k, v in rec["counters"].items():
                prog["counters"][k] = prog["counters"].get(k, 0) + v
    for ld in loads:
        ld.setdefault("program", None)


def loads(run) -> List[Dict]:
    """The run's kept profiled loads that carry a program record."""
    todo = [ld for ld in run.loads if "program" not in ld]
    if todo:
        attach(todo, _take())
    return [ld for ld in run.loads if ld["program"]]


def span_ns(load: Dict, names) -> int:
    return sum(s["end_ns"] - s["start_ns"] for s in load["program"]["spans"]
               if s["name"] in names)


def span_ms(run, names) -> Optional[float]:
    """Ms a load in the spans named ``names``, summed (the spans of one
    name never nest), over the loads with a record that has one."""
    lds = loads(run)
    if not any(s["name"] in names for ld in lds
               for s in ld["program"]["spans"]):
        return None
    return sum(span_ns(ld, names) for ld in lds) / len(lds) / 1e6


def intersect(a, b) -> float:
    """The length of the intersection of two lists of intervals."""
    a, b = trace.union(a), trace.union(b)
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(load: Dict) -> List:
    """The stretches of a load's host span (us) in which none of its
    records runs on the card."""
    lo, hi = load["span"]
    out, t = [], lo
    for s, e in trace.union([(s, e) for _, s, e in load["records"]]):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
