"""Batched serving engine with continuous-batching slot management; the
port of ``repro/serve/engine.py``.

A fixed pool of ``batch`` slots; finished sequences release their slot and
queued requests claim it (their prompt is prefilled into the slot's cache
rows).  The scheduling is host code over numpy, as in the reference; the
decode step runs on the model's device.

Scheduling invariants (the reference's, held by tests/test_torch_serve.py):

* queued requests are never dropped: a request stays in the queue until
  a slot admits it, slots freed by completions this tick are refilled
  in the same tick, and ``run()`` drains queue + slots to empty by
  default (``max_ticks`` is an explicit safety bound, not a silent
  drop point),
* admission is FIFO: requests enter slots in submit order, so per-slot
  completion order follows admission order,
* ``max_active`` caps how many slots admit concurrently (<= ``batch``);
  the serving runtime lowers it under straggler pressure to degrade
  throughput instead of stalling, and restores it when pressure clears.

A prompt is prefilled by full-batch decode steps, one token each, exactly
as the reference does: each such step also rewrites the other slots'
cache rows at their own ``(pos, tok)`` (the same values again).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.env import resolve_device
from ..models.transformer import init_caches
from .step import make_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None    # slot that served it (set at admission)


class ServeEngine:
    """``model`` must live on ``device`` (default CUDA; ``"cpu"`` runs the
    plain path on the host)."""

    def __init__(self, cfg, model, *, batch: int = 8, max_seq: int = 512,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"ServeEngine: the model is on {model.device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.model = model
        self.batch = batch
        self.max_seq = max_seq
        self.max_active = batch       # admission width; degradable at runtime
        with torch.inference_mode():
            self.caches = init_caches(cfg, batch, max_seq, self.device)
        self.decode = make_decode_step(cfg, max_seq)
        self.pos = np.zeros(batch, np.int32)
        self.tok = np.zeros(batch, np.int32)
        self.slots: List[Optional[Request]] = [None] * batch
        self.queue: List[Request] = []
        self.completed: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _admit(self):
        active = self._active()
        for slot in range(self.batch):
            if active >= self.max_active:
                break
            if self.slots[slot] is None and self.queue:
                req = self.queue.pop(0)
                req.slot = slot
                self.slots[slot] = req
                active += 1
                # prefill the prompt into this slot by stepping tokens
                for i, t in enumerate(req.prompt[:-1]):
                    self._step_slot(slot, int(t), i)
                self.pos[slot] = len(req.prompt) - 1
                self.tok[slot] = int(req.prompt[-1])

    def _batch(self, tok: np.ndarray, pos: np.ndarray) -> dict:
        return {"token": torch.from_numpy(tok).to(self.device),
                "pos": torch.from_numpy(pos).to(self.device)}

    def _step_slot(self, slot: int, token: int, pos: int) -> torch.Tensor:
        """One full-batch decode step with ``slot`` at ``(pos, token)``;
        returns the next tokens on the device (the caller ignores them)."""
        tok = self.tok.copy()
        ps = self.pos.copy()
        tok[slot] = token
        ps[slot] = pos
        nxt, _, self.caches = self.decode(self.model, self.caches,
                                          self._batch(tok, ps))
        return nxt

    def step(self) -> int:
        """One engine tick: admit, decode one token for all active
        slots, refill slots freed by completions (so the queue drains
        even when every slot turns over at a tick boundary)."""
        self._admit()
        active = [s for s in range(self.batch) if self.slots[s] is not None]
        if not active:
            return 0
        nxt, _, self.caches = self.decode(
            self.model, self.caches, self._batch(self.tok.copy(),
                                                 self.pos.copy()))
        nxt = nxt.cpu().numpy()
        for s in active:
            req = self.slots[s]
            req.out.append(int(nxt[s]))
            self.pos[s] += 1
            self.tok[s] = int(nxt[s])
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_seq - 1:
                req.done = True
                self.completed.append(req)
                self.slots[s] = None
        if self.queue:
            self._admit()             # same-tick refill of freed slots
        return len(active)

    def run(self, max_ticks: Optional[int] = None) -> int:
        """Tick until queue and slots are empty.  ``max_ticks`` bounds
        the loop for tests/timeouts; hitting it raises so a stalled
        scheduler can never silently drop still-queued requests."""
        ticks = 0
        while self.queue or any(r is not None for r in self.slots):
            if max_ticks is not None and ticks >= max_ticks:
                pending = len(self.queue) + self._active()
                raise RuntimeError(
                    f"ServeEngine.run: {pending} requests still pending "
                    f"after max_ticks={max_ticks}")
            self.step()
            ticks += 1
        return ticks
