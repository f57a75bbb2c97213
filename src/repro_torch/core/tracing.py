"""Spans and counters of the loads that run under ``torch.profiler``.

A load is recorded when a ``torch.profiler`` session runs on the thread
that starts it: :func:`begin` asks ``torch.autograd._profiler_enabled()``
once, at ``open_graph`` and again at a product request on the handle
(``GraphSource.csr()``, ``.edgelist()``); both share the handle's
:class:`Load` and so its id.  A load's record holds

- spans: name, start and end in ``time.time_ns()`` (Unix time, the clock
  of the profiler's host events), the thread, the enclosing span and the
  load's id;
- counters (:func:`count`): batches, bytes staged, pinned bytes allocated,
  and the request's non-zero differences of ``kernels._lib.LAUNCHES``
  (``launches.<kernel>``) and of :func:`.faults.counters`
  (``faults.<counter>``), read where they live.  Those two are
  process-wide: requests recorded at the same time on two threads each
  count the other's launches and retries.

With :data:`MIRROR` set (``REPRO_TRACE_RANGES=1``) every span of the
thread that started the request is also a range of the profiler
(``record_function``'s C++ body), so the profiler's own trace names it.
It is off by default: each range takes one of the profiler's correlation
ids, so mirrored spans shift the ids of every later range, and a trace
reader that matches the card's records to their launches by correlation
id (``gvelbench/trace.py``) can then take the card's image of an
enclosing range for a launch's record.
Another thread (the loader's prefetch thread) is handed the place to
record into (:func:`here`) and keeps its spans here only: a profiler in
its default configuration records the thread that started it.
:func:`take` returns the records and forgets them; only the last
:data:`KEEP` loads are kept, so a long profile holds bounded memory.

Not recording, :func:`span` and :func:`count` check one flag and return a
shared no-op: no allocation, no ``record_function``.  A span closes when
the code it wraps raises.
"""
from __future__ import annotations

import collections
import functools
import itertools
import operator
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

KEEP = 64                  # finished loads kept until take()
#: mirror the starting thread's spans into the profiler as ranges
MIRROR = os.environ.get("REPRO_TRACE_RANGES", "0") not in ("", "0")
# the C++ body of torch.profiler.record_function: a host event of the same
# name, its time taken within a microsecond of the call, at a seventh of
# the cost
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.profiler.record_function)

_ids = itertools.count(1)
_tls = threading.local()   # .stack: the open spans of this thread
_lock = threading.Lock()
_kept: "collections.deque[Load]" = collections.deque(maxlen=KEEP)
_requests = 0              # recorded requests running, on any thread


class Load:
    """One load's record: spans ``(name, start_ns, end_ns, thread, parent,
    span id)`` as they close, and counters."""

    __slots__ = ("id", "spans", "counters", "_sids", "_lock", "_kept")

    def __init__(self):
        self.id = next(_ids)
        self.spans: List[tuple] = []
        self.counters: Dict[str, int] = {}
        self._sids = itertools.count(1)
        self._lock = threading.Lock()
        self._kept = False

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def drain(self) -> Dict:
        """The record so far as a dict, and a fresh start."""
        with self._lock:
            spans, self.spans = self.spans, []
            counters, self.counters = self.counters, {}
        return {"id": self.id, "counters": counters,
                "spans": [{"name": n, "start_ns": s, "end_ns": e,
                           "thread": t, "parent": p, "span": i}
                          for n, s, e, t, p, i in spans]}


class At(NamedTuple):
    """Where a span opens: the load, the enclosing span's id (0: none),
    whether to mirror it into the profiler, and the thread that may."""

    load: Load
    parent: int
    mirror: bool
    thread: int


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "at", "sid", "start", "rf", "stack", "thread")

    def __init__(self, name: str, at: At):
        self.name, self.at = name, at

    def __enter__(self):
        load, _, mirror, thread = self.at
        me = threading.get_ident()
        mirror = mirror and me == thread
        self.sid = next(load._sids)
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(At(load, self.sid, mirror, me))
        self.stack, self.thread = stack, me
        if mirror:
            # the clock read and the profiler's range in one C-level
            # sequence: no bytecode runs between them, so the interpreter
            # cannot pass its lock to another thread there, and the two
            # clocks agree within microseconds
            self.rf = _record_function(self.name)
            self.start, _ = map(operator.call, (time.time_ns,
                                                self.rf.__enter__))
        else:
            self.rf = None
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            _, end = map(operator.call, (
                functools.partial(self.rf.__exit__, *exc), time.time_ns))
        else:
            end = time.time_ns()
        self.stack.pop()
        load = self.at.load
        with load._lock:
            load.spans.append((self.name, self.start, end, self.thread,
                               self.at.parent, self.sid))
        return False


def _counter_base() -> Dict[str, int]:
    from ..kernels import _lib
    from . import faults
    base = {f"launches.{k}": v for k, v in _lib.LAUNCHES.items()}
    base.update((f"faults.{k}", v) for k, v in faults.counters().items())
    return base


class _Request(_Span):
    """A request's root span: it raises the flag while it runs, counts the
    request's differences of the process-wide counters and keeps the load
    when it ends."""

    __slots__ = ("base",)

    def __enter__(self):
        global _requests
        with _lock:
            _requests += 1
        self.base = _counter_base()
        return super().__enter__()

    def __exit__(self, *exc):
        global _requests
        load = self.at.load
        try:
            super().__exit__(*exc)
            for k, v in _counter_base().items():
                if v != self.base.get(k, 0):
                    load.count(k, v - self.base.get(k, 0))
        finally:
            with _lock:
                _requests -= 1
                if not load._kept:
                    if len(_kept) == KEEP:      # the oldest is forgotten
                        _kept[0]._kept = False
                    load._kept = True
                    _kept.append(load)
        return False


def begin(load: Optional[Load] = None) -> Optional[Load]:
    """The load a request starting on this thread records into: ``load``
    (the handle's) or a new one while a profiler runs here, else None."""
    if not torch.autograd._profiler_enabled():
        return None
    return Load() if load is None else load


def request(load: Optional[Load], name: str):
    """The root span of a request on ``load`` (from :func:`begin`); a child
    span when this thread is already inside a request of the same load."""
    if load is None:
        return _NOOP
    stack = getattr(_tls, "stack", None)
    if stack and stack[-1].load is load:
        return _Span(name, stack[-1])
    return _Request(name, At(load, 0, MIRROR, threading.get_ident()))


def here() -> Optional[At]:
    """This thread's place in a recorded load, to hand to another thread
    (:func:`span`'s ``at``); None when not recording."""
    if not _requests:
        return None
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def span(name: str, at: Optional[At] = None):
    """A span named ``name`` in this thread's recorded load, or at ``at``
    (:func:`here` of another thread); a no-op when not recording."""
    if at is None:
        if not _requests:
            return _NOOP
        stack = getattr(_tls, "stack", None)
        if not stack:
            return _NOOP
        at = stack[-1]
    return _Span(name, at)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of this thread's recorded load."""
    if not _requests:
        return
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1].load.count(name, n)


def take() -> List[Dict]:
    """The loads recorded since the last call, oldest first, each
    ``{"id", "spans": [{"name", "start_ns", "end_ns", "thread", "parent",
    "span"}], "counters": {...}}`` (``parent`` 0 for a request's root), and
    forget them."""
    with _lock:
        loads = list(_kept)
        _kept.clear()
        for ld in loads:
            ld._kept = False
    return [ld.drain() for ld in loads]
