"""Recovery for the loading stack: bounded retries and the watchdog.

The port's copy of the recovery half of ``repro/core/faults.py``
(``StageTimeout``, ``WATCHDOG_S``, ``is_transient``, ``call_with_retries``);
the fault-injection harness is not ported yet.
"""
from __future__ import annotations

import errno
import os
import time
from typing import Callable, Optional

#: attempts per IO call (1 = no retry); $REPRO_IO_RETRIES
DEFAULT_ATTEMPTS = max(1, int(os.environ.get("REPRO_IO_RETRIES", "3")))
#: first-retry sleep; doubles per attempt; $REPRO_IO_BACKOFF_S
DEFAULT_BACKOFF_S = float(os.environ.get("REPRO_IO_BACKOFF_S", "0.005"))
#: seconds a staging/prefetch wait may block before StageTimeout;
#: $REPRO_WATCHDOG_S
WATCHDOG_S = float(os.environ.get("REPRO_WATCHDOG_S", "120"))

#: OSError errnos retried as transient.  Missing files, permissions and
#: directory mistakes fail at once.
TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY,
    errno.ETIMEDOUT, errno.ESTALE, errno.ECONNRESET,
})


class StageTimeout(TimeoutError):
    """A staging/prefetch worker produced nothing within the watchdog
    budget.  The message names the file and byte span; the stuck thread
    is abandoned, never joined."""


def is_transient(exc: BaseException) -> bool:
    """True for the OSError class worth retrying (EIO, EAGAIN, ...)."""
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


def call_with_retries(fn: Callable[[], object], *,
                      describe: str = "io operation",
                      attempts: Optional[int] = None,
                      backoff_s: Optional[float] = None):
    """``fn()`` with bounded, exponentially backed-off retries of transient
    failures; other exceptions, and the last transient one, propagate."""
    attempts = DEFAULT_ATTEMPTS if attempts is None else max(1, int(attempts))
    backoff_s = DEFAULT_BACKOFF_S if backoff_s is None else float(backoff_s)
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as exc:
            if not is_transient(exc) or attempt + 1 >= attempts:
                raise
            time.sleep(backoff_s * (2 ** attempt))
    raise AssertionError(f"{describe}: unreachable")
