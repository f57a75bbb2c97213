"""Fault-tolerance coordinator: checkpoint/restart, stragglers, preemption.

The port's own copy of the reference's ``ft/coordinator.py``, which
imports no JAX; every policy and event string is the reference's.

Single-process embodiment of the control plane a 1000-node job needs;
every policy is a pure function of observable timings/flags so the unit
tests can inject failures deterministically.

  * step-granular async checkpointing every `ckpt_every` steps, atomic
    on disk, with deterministic data skip on restart (the data pipeline
    is step-indexed, so resume(step=n) replays nothing),
  * straggler detection: a step slower than `straggler_factor` x the
    trailing-median is flagged; policy "warn" logs, "rebatch" re-issues
    the step with the same data (idempotent because the step index did
    not advance), "degrade" tells the serving loop to shrink its batch /
    admission width instead of stalling (the serving runtime halves
    engine occupancy; per-walk corpus keying keeps the surviving rows
    bitwise identical — see repro_torch.serve.runtime),
  * preemption: SIGTERM/SIGUSR1 set a flag; the loop checkpoints and
    exits cleanly at the next step boundary,
  * failure injection: `inject_failure(step)` raises inside the loop to
    exercise restart-from-checkpoint in tests,
  * elastic restart: on resume the mesh may have a different device
    count — restore goes through the checkpoint slice's reshard (not
    ported yet; ROADMAP Queue 1 item 5).

Signal handlers are installed only with ``handle_signals=True``, and
the previously-installed handlers are saved and put back by
:meth:`Coordinator.close` (the class is a context manager), so stacked
or sequential coordinators never clobber each other's — or the host
application's — handlers.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable, Dict, List, Optional

_POLICIES = ("warn", "rebatch", "degrade")


@dataclasses.dataclass
class FTConfig:
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 20
    straggler_policy: str = "warn"      # warn | rebatch | degrade
    handle_signals: bool = False


class Coordinator:
    def __init__(self, cfg: FTConfig):
        if cfg.straggler_policy not in _POLICIES:
            raise ValueError(
                f"straggler_policy must be one of {_POLICIES}, "
                f"got {cfg.straggler_policy!r}")
        self.cfg = cfg
        self.step_times: List[float] = []
        self.preempted = False
        self.events: List[str] = []
        self._fail_at: Optional[int] = None
        self._prev_handlers: Dict[int, object] = {}
        if cfg.handle_signals:
            for sig in (signal.SIGTERM, signal.SIGUSR1):
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        self.preempted = True
        self.events.append(f"preempt signal {signum}")

    def close(self) -> None:
        """Restore the signal handlers this coordinator displaced.
        Idempotent; a coordinator that installed none is a no-op."""
        while self._prev_handlers:
            sig, prev = self._prev_handlers.popitem()
            signal.signal(sig, prev)

    def __enter__(self) -> "Coordinator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ---- test hooks ----------------------------------------------------------
    def inject_failure(self, step: int):
        self._fail_at = step

    def maybe_fail(self, step: int):
        if self._fail_at is not None and step == self._fail_at:
            self._fail_at = None
            self.events.append(f"injected failure at step {step}")
            raise RuntimeError(f"injected node failure at step {step}")

    # ---- policies -------------------------------------------------------------
    def observe_step(self, seconds: float) -> str:
        """Record a step time; returns action: ok | straggler-warn |
        straggler-rebatch | straggler-degrade."""
        w = self.step_times[-self.cfg.straggler_window:]
        self.step_times.append(seconds)
        if len(w) >= 5:
            med = statistics.median(w)
            if seconds > self.cfg.straggler_factor * med:
                act = f"straggler-{self.cfg.straggler_policy}"
                self.events.append(
                    f"straggler: {seconds:.3f}s vs median {med:.3f}s -> {act}")
                return act
        return "ok"

    def observe_fault(self, description: str) -> str:
        """Record a data-plane fault (corrupt graph section, stuck
        reader) in the event log; returns the action the straggler
        policy implies — ``degrade`` narrows serving instead of
        stalling it, any other policy just logs (``warn``).  The
        serving runtime routes corrupt-graph detections through here so
        the coordinator's event log is the one fault timeline."""
        act = ("degrade" if self.cfg.straggler_policy == "degrade"
               else "warn")
        self.events.append(f"fault: {description} -> {act}")
        return act

    def should_checkpoint(self, step: int) -> bool:
        return step > 0 and step % self.cfg.ckpt_every == 0

    def should_stop(self) -> bool:
        return self.preempted
