"""Process-level hot-graph cache: a bounded, thread-safe LRU of open
:class:`~.source.GraphSource` handles, and the serving ``query(path, op)``
built on it.

The port of ``repro/core/cache.py``.  A graph-query service (ParaGrapher's
serving scenario: thousands of point and range reads per second against a
snapshot corpus) must not pay open-and-validate per request, must notice a
snapshot swapped under it, and must bound how many mmaps and decoded
sections it pins::

    from repro_torch.core.cache import query

    nbrs = query("web.gvel", "neighbors", vertex=42)   # a tensor on CUDA
    rows = query("web.gvel", "rows", rows=range(100, 200))
    csr  = query("web.gvel", "csr", device="cpu")

* **Keyed by content**: an entry is checked against ``(mtime_ns, size)``
  on every hit; a swapped file invalidates its entry on the next request.
* **Bounded LRU** of ``capacity`` open handles.
* **Single-open**: concurrent requests for one cold slot wait on the
  opener (a watchdogged wait) and share its handle.  The handle builds a
  cold product once and publishes it only when its device work is done
  (:class:`~.source.GraphSource`), so threads on other CUDA streams may
  read it.
* **The device is part of the slot**, resolved first (``None``,
  ``"cuda"``, ``"cuda:0"`` and ``torch.device("cuda", 0)`` are one slot),
  so one card never holds two copies of a graph for one request shape.
* **Quarantine**: a corrupt section (a :class:`~.snapshot.SnapshotError`)
  quarantines ``(path, section)``; requests that touch it get a
  :class:`~.faults.CorruptGraphError` while other sections and graphs keep
  serving, until the file is swapped on disk.

The default cache (capacity ``$REPRO_CACHE_CAPACITY``, else 16) serves the
module-level :func:`query`.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from . import faults as faults_mod
from .env import resolve_device
from .faults import CorruptGraphError, StageTimeout
from .snapshot import SnapshotError
from .source import GraphSource, open_graph

_DEFAULT_CAPACITY = int(os.environ.get("REPRO_CACHE_CAPACITY", "16"))

# the sections each op may read: its quarantine scope.  "info" reads
# headers only and keeps serving (the health probe must outlive the
# corruption it reports).
_OP_SECTIONS: Dict[str, Tuple[str, ...]] = {
    "info": (),
    "csr": ("csr_offsets", "csr_indices", "csr_weights"),
    "full": ("csr_offsets", "csr_indices", "csr_weights"),
    "rows": ("csr_offsets", "csr_indices", "csr_weights"),
    "csr_rows": ("csr_offsets", "csr_indices", "csr_weights"),
    "range": ("csr_offsets", "csr_indices", "csr_weights"),
    "neighbors": ("csr_offsets", "csr_indices", "csr_weights"),
    "point": ("csr_offsets", "csr_indices", "csr_weights"),
    "degree": ("csr_offsets",),
    "edgelist": ("src", "dst", "edge_weights"),
}


class _Pending:
    """One in-flight open: waiters block on ``event``; the opener publishes
    ``source`` or ``error`` before setting it."""

    __slots__ = ("event", "source", "error")

    def __init__(self):
        self.event = threading.Event()
        self.source: Optional[GraphSource] = None
        self.error: Optional[BaseException] = None


class _Entry:
    __slots__ = ("key", "source")

    def __init__(self, key, source):
        self.key = key
        self.source = source


def _stat_key(path: str) -> Tuple[int, int]:
    st = os.stat(path)
    return st.st_mtime_ns, st.st_size


class SourceCache:
    """Bounded, thread-safe LRU of open :class:`GraphSource` handles, one
    per ``(path, open keywords)`` slot, each checked against the file's
    ``(mtime_ns, size)``.

    ``get`` returns the cached handle while the file on disk matches,
    else drops the stale entry and reopens.  Every open keyword is part of
    the slot (values must be hashable); ``device`` is resolved first and
    always present, so ``get(p)`` and ``get(p, device="cuda:0")`` share a
    slot on card 0.  ``open_fn`` (default :func:`open_graph`) receives the
    resolved device.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, *, open_fn=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._open_fn = open_graph if open_fn is None else open_fn
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._pending: Dict[tuple, _Pending] = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidations = 0
        # (path, section) -> {"stat": (mtime_ns, size) | None,
        #                     "error": str, "count": int}
        self._quarantined: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._faults = {"open_retries": 0, "open_faults": 0,
                        "corrupt_errors": 0, "quarantines": 0,
                        "recovered": 0, "wait_timeouts": 0}

    # -- core ----------------------------------------------------------------

    def get(self, path: str, **open_kw) -> GraphSource:
        """The cached handle for ``path`` opened with ``open_kw``, opened at
        most once per (path, stat, keywords) across threads.  A changed
        file invalidates the old entry and reopens; a raising open is not
        cached (the next request retries)."""
        path = str(path)
        open_kw["device"] = resolve_device(open_kw.get("device"))
        slot = (path, tuple(sorted(
            (k, str(v) if k == "device" else v) for k, v in open_kw.items())))
        while True:
            key = _stat_key(path)       # raises for missing paths: uncached
            with self._lock:
                ent = self._entries.get(slot)
                if ent is not None:
                    if ent.key == key:
                        self._hits += 1
                        self._entries.move_to_end(slot)
                        return ent.source
                    # the file was swapped: drop and reopen (the swap also
                    # lifts any quarantine on the path)
                    del self._entries[slot]
                    self._invalidations += 1
                    self._clear_quarantine_locked(path, key)
                pending = self._pending.get(slot)
                if pending is None:
                    pending = self._pending[slot] = _Pending()
                    opener = True
                else:
                    opener = False
            if not opener:
                # watchdogged: a wedged opener must not strand every waiter
                if not pending.event.wait(faults_mod.WATCHDOG_S):
                    with self._lock:
                        self._faults["wait_timeouts"] += 1
                    raise StageTimeout(
                        f"SourceCache: open of {path} still pending after "
                        f"{faults_mod.WATCHDOG_S:.1f}s (REPRO_WATCHDOG_S); "
                        f"the opening thread is stuck")
                if pending.source is not None:
                    # answered without opening the file: a hit
                    with self._lock:
                        self._hits += 1
                    return pending.source
                continue                # the opener failed: try ourselves
            # the pending event is set on every exit from here, or every
            # waiter would block on a slot nobody owns
            try:
                source = faults_mod.call_with_retries(
                    lambda: self._open_once(path, open_kw),
                    describe=f"SourceCache open {path}",
                    on_retry=self._note_open_retry)
                pending.source = source
                with self._lock:
                    self._misses += 1
                    self._entries[slot] = _Entry(key, source)
                    self._entries.move_to_end(slot)
                    while len(self._entries) > self.capacity:
                        self._entries.popitem(last=False)
                        self._evictions += 1
                return source
            except BaseException as exc:
                pending.error = exc
                raise
            finally:
                with self._lock:
                    self._pending.pop(slot, None)
                pending.event.set()

    def _open_once(self, path: str, open_kw: Dict[str, Any]) -> GraphSource:
        if faults_mod._ACTIVE is not None:      # the open fault site
            faults_mod.inject("open", 0, where=path)
        return self._open_fn(path, **open_kw)

    def _note_open_retry(self, exc: BaseException) -> None:
        with self._lock:
            self._faults["open_retries"] += 1

    def query(self, path: str, op: str, *, rows=None, vertex=None,
              method: str = "staged", rho: int = 4,
              with_weights: bool = False, **open_kw) -> Any:
        """One request against the cache.  ``op`` selects the product:

        ==============  ==================================================
        op              result
        ==============  ==================================================
        ``info``        :class:`~.source.SourceInfo`
        ``csr``         the full :class:`~.types.CSR` (alias ``full``)
        ``rows``        ``.csr(rows=rows)``, a row-local CSR slice
                        (aliases ``csr_rows``, ``range``)
        ``neighbors``   ``.neighbors(vertex)`` (alias ``point``)
        ``degree``      ``.degree(vertex)``
        ``edgelist``    the full :class:`~.types.EdgeList`
        ==============  ==================================================

        Tensors land on the slot's device (``device=`` among ``open_kw``,
        default CUDA).  A corrupt section quarantines ``(path, section)``:
        this and later requests touching it raise
        :class:`CorruptGraphError` until the file is swapped on disk.
        """
        self.check_quarantine(path, _OP_SECTIONS.get(op))
        src = self.get(path, **open_kw)
        try:
            if op == "info":
                return src.info()
            if op in ("csr", "full"):
                return src.csr(method=method, rho=rho)
            if op in ("rows", "csr_rows", "range"):
                if rows is None:
                    raise ValueError("op 'rows' needs rows=")
                return src.csr(method=method, rho=rho, rows=rows)
            if op in ("neighbors", "point"):
                if vertex is None:
                    raise ValueError("op 'neighbors' needs vertex=")
                return src.neighbors(vertex, with_weights=with_weights)
            if op == "degree":
                if vertex is None:
                    raise ValueError("op 'degree' needs vertex=")
                return src.degree(vertex)
            if op == "edgelist":
                return src.edgelist()
        except SnapshotError as exc:
            raise self.report_corrupt(path, exc, op=op) from exc
        raise ValueError(
            f"unknown query op {op!r}; one of: info, csr, rows, neighbors, "
            f"degree, edgelist")

    # -- corruption quarantine -----------------------------------------------

    def check_quarantine(self, path: str,
                         sections: Optional[Tuple[str, ...]] = None) -> None:
        """Raise :class:`CorruptGraphError` when a live quarantine entry for
        ``path`` covers one of ``sections`` (any section when ``None``).
        Entries whose file changed on disk since the corrupt read are
        cleared instead: the swap-recovery contract."""
        path = str(path)
        with self._lock:
            entries = [(k, rec) for k, rec in self._quarantined.items()
                       if k[0] == path]
        if not entries:
            return
        try:
            key = _stat_key(path)
        except OSError:
            key = None                  # a vanished file counts as swapped
        hit = None
        with self._lock:
            for (p, sec), rec in entries:
                if rec["stat"] != key:
                    if self._quarantined.pop((p, sec), None) is not None:
                        self._faults["recovered"] += 1
                    continue
                # an op that reads no section ("info") is never blocked,
                # even by an "unknown" quarantine
                if sections is None or (len(sections) > 0 and
                                        (sec in sections or sec == "unknown")):
                    hit = (sec, rec)
            if hit is not None:
                self._faults["corrupt_errors"] += 1
                hit[1]["count"] += 1
        if hit is not None:
            sec, rec = hit
            raise CorruptGraphError(
                f"{path}: section {sec!r} is quarantined after a corrupt "
                f"read ({rec['error']}); serving resumes when the file is "
                f"replaced on disk",
                path=path, section=sec)

    def report_corrupt(self, path: str, exc: BaseException, *,
                       op: Optional[str] = None) -> CorruptGraphError:
        """Record a corrupt read of ``path``, quarantining the section that
        ``exc.section`` names (else ``"unknown"``), and return the
        structured error for the caller to raise.  Idempotent per section;
        every report counts."""
        path = str(path)
        section = getattr(exc, "section", None) or "unknown"
        try:
            key = _stat_key(path)
        except OSError:
            key = None
        with self._lock:
            rec = self._quarantined.get((path, section))
            if rec is None:
                rec = self._quarantined[(path, section)] = {
                    "stat": key, "error": str(exc), "count": 0}
                self._faults["quarantines"] += 1
            rec["count"] += 1
            rec["stat"] = key
            rec["error"] = str(exc)
            self._faults["corrupt_errors"] += 1
        return CorruptGraphError(
            f"{path}: corrupt read of section {section!r}"
            f"{f' during op {op!r}' if op else ''}: {exc}",
            path=path, section=section, op=op)

    def quarantined(self) -> List[Dict[str, Any]]:
        """Live quarantine entries (path, section, error, count)."""
        with self._lock:
            return [{"path": p, "section": s, "error": rec["error"],
                     "count": rec["count"]}
                    for (p, s), rec in self._quarantined.items()]

    def _clear_quarantine_locked(self, path: str, new_key) -> None:
        """Drop ``path``'s quarantine entries whose recorded stat no longer
        matches ``new_key`` (the file was swapped).  Holds the lock."""
        for k in [k for k in self._quarantined if k[0] == path]:
            if self._quarantined[k]["stat"] != new_key:
                del self._quarantined[k]
                self._faults["recovered"] += 1

    # -- management ----------------------------------------------------------

    def invalidate(self, path: Optional[str] = None) -> int:
        """Drop the entries of ``path`` (every keyword variant), or every
        entry with ``path=None``; returns how many.  Handles in use stay
        valid for their holders."""
        with self._lock:
            if path is None:
                n = len(self._entries)
                self._entries.clear()
            else:
                path = str(path)
                stale = [s for s in self._entries if s[0] == path]
                for s in stale:
                    del self._entries[s]
                n = len(stale)
            self._invalidations += n
            return n

    def clear(self) -> None:
        self.invalidate(None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, path: str) -> bool:
        with self._lock:
            return any(s[0] == str(path) for s in self._entries)

    def stats(self) -> Dict[str, Any]:
        """Counters since construction: ``hits``, ``misses`` (opens that
        were cached), ``evictions``, ``invalidations`` (stat changes and
        explicit), ``size``, ``capacity``; ``frame_cache``, the decoded-frame
        memo summed over the hot handles' pinned snapshots (frames, bytes,
        hits, evictions); and ``faults``: this cache's open retries,
        corrupt reads, quarantines entered and recovered and watchdogged
        waits, the live quarantine list, the process-wide recovery counters
        of :mod:`.faults`, and the active plan's injected counts."""
        plan = faults_mod.active_plan()
        with self._lock:
            frame = {"frames": 0, "bytes": 0, "hits": 0, "evictions": 0}
            for ent in self._entries.values():
                fc = getattr(ent.source, "frame_cache_stats", None)
                fc = fc() if callable(fc) else None
                if fc:
                    for k in frame:
                        frame[k] += fc.get(k, 0)
            faults = dict(self._faults)
            faults["quarantined"] = [
                {"path": p, "section": s, "count": rec["count"]}
                for (p, s), rec in self._quarantined.items()]
            faults.update(faults_mod.counters())
            faults["injected"] = {} if plan is None else plan.injected()
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "invalidations": self._invalidations,
                    "size": len(self._entries),
                    "capacity": self.capacity,
                    "frame_cache": frame,
                    "faults": faults}


_default: Optional[SourceCache] = None
_default_lock = threading.Lock()


def default_cache() -> SourceCache:
    """The process-wide cache behind the module-level :func:`query`."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SourceCache()
        return _default


def query(path: str, op: str, **kw) -> Any:
    """Serve one graph query through the process-wide cache (see
    :meth:`SourceCache.query` for the ops)."""
    return default_cache().query(path, op, **kw)
