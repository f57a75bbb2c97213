"""Async double-buffered batch pipeline; the port of
``repro/data/pipeline.py``.

While the caller consumes step n, a background thread builds (and, with
``device=``, moves) batch n+1, so input never serialises with compute.
Step-indexed sources keep restart deterministic.

``graph_walk_source`` bridges the front door
(:func:`repro_torch.open_graph`) into this pipeline: graph file ->
``GraphSource`` -> CSR on the source's device -> step-indexed walk-batch
source for :class:`Prefetcher`.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch

from ..core import faults


def graph_walk_source(path: str, cfg, batch: int, seq: int, *,
                      engine: str = "device", seed: int = 99,
                      **load_kw) -> Callable[[int], dict]:
    """Load a graph through ``open_graph(path)`` and return a
    deterministic step-indexed source of random-walk LM batches (a
    :class:`repro_torch.data.corpus.WalkCorpus` bound to the handle).
    ``load_kw`` goes to ``open_graph`` (``device=`` among it); ``method``
    and ``rho`` pick the CSR build."""
    from ..core.source import open_graph
    from .corpus import CorpusConfig, WalkCorpus

    method = load_kw.pop("method", "staged")
    rho = load_kw.pop("rho", 4)
    src = open_graph(path, engine=engine, **load_kw)
    corpus = WalkCorpus(src, CorpusConfig(
        batch=batch, seq=seq, vocab_size=cfg.vocab_size, seed=seed,
        method=method, rho=rho))
    return corpus.batch_at


class _Failure:
    """Sentinel carrying a worker exception through the batch queue --
    how a dead lookahead thread reaches its consumer instead of leaving it
    blocked on an empty queue forever."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _to(batch, device):
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    if isinstance(batch, dict):
        return {k: _to(v, device) for k, v in batch.items()}
    return batch


class Prefetcher:
    """Wraps ``source(step) -> batch`` with a lookahead thread.

    ``device``: where batches go (tensors of a batch, or of a dict batch,
    built elsewhere are moved with ``.to(device)``); None leaves them
    where the source built them.

    Failure semantics: an exception in the worker is queued behind any
    batches already built and re-raised from :meth:`get` -- never
    swallowed.  ``get`` bounds its wait by the watchdog budget
    (``timeout`` here, else ``faults.WATCHDOG_S``), raising
    :class:`~repro_torch.core.faults.StageTimeout` when the source is
    stuck rather than hanging the loop.
    """

    def __init__(self, source: Callable[[int], dict], start_step: int = 0,
                 lookahead: int = 2, device=None,
                 timeout: Optional[float] = None):
        self.source = source
        self.device = None if device is None else torch.device(device)
        self._timeout = timeout
        self._q: queue.Queue = queue.Queue(maxsize=lookahead)
        self._stop = threading.Event()
        self._next = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item``, waiting while the queue is full; False once
        :meth:`close` has been called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        # each step is built once: a full queue retries the put, never the
        # source (a batch is thousands of launches on the card)
        step = self._next
        try:
            while not self._stop.is_set():
                batch = self.source(step)
                if self.device is not None:
                    batch = _to(batch, self.device)
                if not self._put((step, batch)):
                    return
                step += 1
        except BaseException as exc:   # propagate through the queue
            self._put((step, _Failure(exc)))

    def get(self, expect_step: Optional[int] = None):
        budget = faults.WATCHDOG_S if self._timeout is None else self._timeout
        try:
            step, batch = self._q.get(timeout=budget)
        except queue.Empty:
            raise faults.StageTimeout(
                f"batch pipeline: no batch produced within {budget:.1f}s "
                f"(REPRO_WATCHDOG_S); the source is stuck") from None
        if isinstance(batch, _Failure):
            self._stop.set()
            raise batch.exc
        if expect_step is not None and step != expect_step:
            raise RuntimeError(f"pipeline desync: got {step}, "
                               f"want {expect_step}")
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
