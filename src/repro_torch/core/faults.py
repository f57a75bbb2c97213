"""Deterministic fault injection and the recovery it exercises.

The port of ``repro/core/faults.py``, both halves in one file so the
recovery code and the chaos harness that tests it cannot drift apart:

* **Injection**: a seeded :class:`FaultPlan` of :class:`FaultSpec`
  entries, active process-wide through :func:`set_fault_plan`, the
  :func:`fault_plan` context, or ``REPRO_FAULTS``
  (``"seed=7;block:oserror@3*2;frame:bitflip@0"``, armed at import).
  Hooks at four sites: ``block`` (staged block batches, through
  :class:`FaultyBlockSource`), ``frame`` (compressed-frame decodes in
  :mod:`.codecs`), ``open`` (:class:`~.cache.SourceCache` cold opens) and
  ``mmap`` (:func:`.blocks.mmap_bytes`) inject transient ``OSError`` s,
  latency, stalls, truncations and bit flips at chosen indices.  With no
  plan active every hook is one ``is None`` test.
* **Recovery**: :func:`call_with_retries` (bounded exponential backoff
  over transient ``OSError`` s; ``REPRO_IO_RETRIES``), the
  :data:`WATCHDOG_S` budget of every staging wait (``REPRO_WATCHDOG_S``,
  read at call time), and the structured errors: :class:`StageTimeout`,
  :class:`ShardLoadError` and :class:`CorruptGraphError`.

Injection raises or stalls *before* the wrapped reader is touched, so a
retried call sees exactly the state the failed one did.  A plan damages
the same bytes as the reference's for the same seed, spec and salt: the
generator is numpy's, seeded ``(seed, index, salt)``.
"""
from __future__ import annotations

import dataclasses
import errno
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FaultSpec", "FaultPlan", "FaultyBlockSource",
    "StageTimeout", "ShardLoadError", "CorruptGraphError",
    "set_fault_plan", "active_plan", "fault_plan", "plan_from_env",
    "inject", "corrupt_bytes", "wrap_block_source",
    "call_with_retries", "is_transient",
    "counters", "reset_counters",
]

SITES = ("block", "frame", "open", "mmap")
KINDS = ("oserror", "latency", "stall", "truncate", "bitflip")

#: attempts per IO call (1 = no retry); $REPRO_IO_RETRIES
DEFAULT_ATTEMPTS = max(1, int(os.environ.get("REPRO_IO_RETRIES", "3")))
#: first-retry sleep; doubles per attempt; $REPRO_IO_BACKOFF_S
DEFAULT_BACKOFF_S = float(os.environ.get("REPRO_IO_BACKOFF_S", "0.005"))
#: seconds a staging/prefetch wait may block before StageTimeout;
#: $REPRO_WATCHDOG_S
WATCHDOG_S = float(os.environ.get("REPRO_WATCHDOG_S", "120"))
#: extra re-executions of a whole shard span after its in-span retries are
#: exhausted; $REPRO_SHARD_RETRIES (read by the sharded load)
SHARD_RETRIES = max(0, int(os.environ.get("REPRO_SHARD_RETRIES", "2")))

#: OSError errnos retried as transient.  Missing files, permissions and
#: directory mistakes fail at once.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY,
    errno.ETIMEDOUT, errno.ESTALE, errno.ECONNRESET,
})


# -- structured errors --------------------------------------------------------


class StageTimeout(TimeoutError):
    """A staging/prefetch worker produced nothing within the watchdog
    budget.  The message names the file and byte span; the stuck thread
    is abandoned, never joined."""


class ShardLoadError(RuntimeError):
    """One shard of a sharded streaming load exhausted its re-execution
    budget.  ``fault_log`` holds one line per failed attempt."""

    def __init__(self, message: str, *, shard: int = -1,
                 fault_log: Sequence[str] = ()):
        super().__init__(message)
        self.shard = int(shard)
        self.fault_log = list(fault_log)


class CorruptGraphError(RuntimeError):
    """The graph at ``path`` has a quarantined ``section`` (a CRC or
    decode failure).  Other sections and other graphs in the same cache
    keep serving; the quarantine lifts when the file is swapped on disk."""

    def __init__(self, message: str, *, path: str = "",
                 section: str = "unknown", op: Optional[str] = None):
        super().__init__(message)
        self.path = str(path)
        self.section = str(section)
        self.op = op


# -- fault plans --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault.

    ``site``   -- ``block`` (block id), ``frame`` (frame index), ``open`` /
                  ``mmap`` (index always 0; ``path`` chooses the file).
    ``kind``   -- ``oserror`` (transient EIO), ``latency`` (short sleep),
                  ``stall`` (sleep ``delay_s``: past the watchdog it is a
                  stuck reader), ``truncate`` (drop trailing bytes),
                  ``bitflip`` (flip one seeded bit).
    ``index``  -- site-local index the fault targets.
    ``times``  -- injections before the spec is spent (< 0: unlimited).
    ``path``   -- substring filter on the target's description.
    """
    site: str
    kind: str
    index: int = 0
    times: int = 1
    path: str = ""
    delay_s: float = 0.05

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"FaultSpec: unknown site {self.site!r}; "
                             f"sites: {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"FaultSpec: unknown kind {self.kind!r}; "
                             f"kinds: {KINDS}")


class FaultPlan:
    """A seeded, thread-safe schedule of :class:`FaultSpec` s.

    ``match`` consumes budgets under a lock, so concurrent staging threads
    see a deterministic total; :meth:`corrupt` is a pure function of
    ``(seed, spec, salt)``."""

    def __init__(self, faults: Iterable[FaultSpec], *, seed: int = 0):
        self.faults: Tuple[FaultSpec, ...] = tuple(faults)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._fired = [0] * len(self.faults)
        self._counts: Dict[str, int] = {}

    def has_site(self, site: str) -> bool:
        return any(f.site == site for f in self.faults)

    def match(self, site: str, index: int, where: str = "") -> List[FaultSpec]:
        """Specs firing for this event; consumes their budgets."""
        out: List[FaultSpec] = []
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.site != site or f.index != int(index):
                    continue
                if f.path and f.path not in where:
                    continue
                if f.times >= 0 and self._fired[i] >= f.times:
                    continue
                self._fired[i] += 1
                key = f"{f.site}:{f.kind}"
                self._counts[key] = self._counts.get(key, 0) + 1
                out.append(f)
        return out

    def injected(self) -> Dict[str, int]:
        """``{"site:kind": count}`` of the faults fired."""
        with self._lock:
            return dict(self._counts)

    def total_injected(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def corrupt(self, data: bytes, spec: FaultSpec, salt: int = 0) -> bytes:
        """A deterministically damaged copy of ``data`` per ``spec``."""
        if not data:
            return data
        rng = np.random.default_rng((self.seed, spec.index, salt))
        if spec.kind == "truncate":
            keep = max(1, len(data) - max(1, len(data) // 4))
            return data[:keep]
        if spec.kind == "bitflip":
            buf = bytearray(data)
            buf[int(rng.integers(len(buf)))] ^= 1 << int(rng.integers(8))
            return bytes(buf)
        return data


# -- activation ---------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None
_ACTIVE_LOCK = threading.Lock()


def set_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` process-wide (``None`` disables injection)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = plan
    return plan


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextmanager
def fault_plan(plan: Optional[FaultPlan]):
    """Activate ``plan`` for the dynamic extent.  ``None`` is a no-op (the
    surrounding plan stays active), so callers thread an optional
    ``LoadOptions.faults`` through unconditionally."""
    global _ACTIVE
    if plan is None:
        yield None
        return
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev


def plan_from_env(spec: Optional[str] = None) -> Optional[FaultPlan]:
    """Parse a ``REPRO_FAULTS`` spec into a plan (``None`` if empty).

    Grammar (``;``-separated entries)::

        seed=<int>
        <site>:<kind>[@<index>][*<times>][~<path-substring>]

    e.g. ``"seed=7;block:oserror@3*2;frame:bitflip@0~web.gvel"``.
    """
    if spec is None:
        spec = os.environ.get("REPRO_FAULTS", "")
    spec = spec.strip()
    if not spec:
        return None
    seed, faults = 0, []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[len("seed="):])
            continue
        site, sep, rest = part.partition(":")
        if not sep:
            raise ValueError(f"REPRO_FAULTS: bad entry {part!r} "
                             f"(want site:kind[@index][*times][~path])")
        path, times, index = "", 1, 0
        if "~" in rest:
            rest, path = rest.split("~", 1)
        if "*" in rest:
            rest, times_s = rest.split("*", 1)
            times = int(times_s)
        kind, _, tail = rest.partition("@")
        if tail:
            index = int(tail)
        faults.append(FaultSpec(site=site, kind=kind, index=index,
                                times=times, path=path))
    return FaultPlan(faults, seed=seed)


# a REPRO_FAULTS plan is live from import: how a chaos run arms a
# subprocess without touching its code
set_fault_plan(plan_from_env())


# -- injection hooks ----------------------------------------------------------


def inject(site: str, index: int, *, where: str = "") -> List[FaultSpec]:
    """Fire the active plan's faults for one event.

    ``oserror`` raises and ``latency``/``stall`` sleep here, before the
    caller touches its reader, which is what makes a retry safe.  Data
    kinds (``truncate``/``bitflip``) are returned for the caller to apply
    to the bytes it is about to produce."""
    plan = _ACTIVE
    if plan is None:
        return []
    mutators: List[FaultSpec] = []
    for f in plan.match(site, index, where):
        if f.kind in ("latency", "stall"):
            time.sleep(f.delay_s)
        elif f.kind == "oserror":
            raise OSError(
                errno.EIO,
                f"injected transient IO error at {where or site} "
                f"(index {index})")
        else:
            mutators.append(f)
    return mutators


def corrupt_bytes(data: bytes, spec: FaultSpec, salt: int = 0) -> bytes:
    plan = _ACTIVE
    return data if plan is None else plan.corrupt(data, spec, salt)


class FaultyBlockSource:
    """A block source that injects ``block``-site faults.

    Raising and sleeping faults fire before delegation, so the inner
    source's cursor is untouched by an injected failure and the retried
    ``stage`` is exact (nor is the arena slot taken, so its fence is
    waited once).  Data faults damage a copy of the staged flat span,
    never the arena slot: block ``b``'s row (``overlap + beta`` bytes at
    ``(b - first) * beta``) is damaged as the reference damages its row
    (seeded by ``salt=b``), padded with newlines when truncated, and
    written back into the copy, so the ``overlap`` bytes it shares with
    the next row change for both."""

    def __init__(self, inner, where: str):
        self._inner = inner
        self._where = str(where)
        self._describe = getattr(inner, "_describe", self._where)

    @property
    def length(self):
        return self._inner.length

    def stage(self, plan, block_ids, arena=None, check_lines: bool = False):
        ids = np.asarray(block_ids, dtype=np.int64)
        mutators: List[Tuple[FaultSpec, int]] = []
        for b in ids:
            for f in inject("block", int(b), where=self._where):
                mutators.append((f, int(b)))
        out = self._inner.stage(plan, block_ids, arena=arena,
                                check_lines=check_lines)
        if mutators:
            out = np.array(out, copy=True)      # never damage the arena ring
            for f, b in mutators:
                lo = (b - int(ids[0])) * plan.beta
                raw = out[lo:lo + plan.buf_len].tobytes()
                bad = corrupt_bytes(raw, f, salt=b)
                out[lo:lo + plan.buf_len] = np.frombuffer(
                    bad.ljust(len(raw), b"\n"), np.uint8)
        return out

    def finish(self) -> None:
        self._inner.finish()


def wrap_block_source(source, where: str):
    """Wrap ``source`` when the active plan has block-site faults; else
    return it untouched (the zero-fault path has no wrapper at all)."""
    plan = _ACTIVE
    if plan is None or not plan.has_site("block"):
        return source
    return FaultyBlockSource(source, where)


# -- retries + counters -------------------------------------------------------

_COUNT_LOCK = threading.Lock()
_COUNTERS = {"io_retries": 0, "stage_timeouts": 0, "shard_retries": 0}


def _count(key: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        _COUNTERS[key] = _COUNTERS.get(key, 0) + n


def counters() -> Dict[str, int]:
    """Process-wide recovery counters (IO retries, stage timeouts, shard
    re-executions), surfaced through ``SourceCache.stats()["faults"]``."""
    with _COUNT_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _COUNT_LOCK:
        for k in _COUNTERS:
            _COUNTERS[k] = 0


def is_transient(exc: BaseException) -> bool:
    """True for the OSError class worth retrying (EIO, EAGAIN, ...), never
    for missing files or permission errors."""
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


def call_with_retries(fn: Callable[[], object], *,
                      describe: str = "io operation",
                      attempts: Optional[int] = None,
                      backoff_s: Optional[float] = None,
                      on_retry: Optional[Callable[[BaseException], None]]
                      = None):
    """``fn()`` with bounded, exponentially backed-off retries of transient
    failures, each counted as ``io_retries`` (and passed to ``on_retry``);
    other exceptions, and the last transient one, propagate.  Defaults are
    the module knobs, read at call time."""
    attempts = DEFAULT_ATTEMPTS if attempts is None else max(1, int(attempts))
    backoff_s = DEFAULT_BACKOFF_S if backoff_s is None else float(backoff_s)
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as exc:
            if not is_transient(exc) or attempt + 1 >= attempts:
                raise
            _count("io_retries")
            if on_retry is not None:
                on_retry(exc)
            time.sleep(backoff_s * (2 ** attempt))
    raise AssertionError(f"{describe}: unreachable")
