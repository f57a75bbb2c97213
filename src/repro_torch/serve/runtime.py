"""Graph-walk serving runtime: snapshot corpus -> continuous batching
under churn; the port of ``repro/serve/runtime.py``.

A :class:`ServeRuntime` owns

* a :class:`~repro_torch.core.cache.SourceCache` -- every request resolves
  its graph through an mtime/size-validated handle, so a snapshot swapped
  on disk under the live server is picked up on the **next request** with
  no restart and no dropped in-flight work (in-flight prompts were already
  derived from the old handle and finish normally),
* a continuous-batching :class:`~repro_torch.serve.engine.ServeEngine` --
  walk-LM requests (prompt = a deterministic random walk from the
  requested graph, tokens = vertex ids mod vocab) share decode ticks
  across slots,
* a :class:`~repro_torch.ft.coordinator.Coordinator` -- straggler ticks
  *degrade* the engine's admission width (halve ``max_active``) instead
  of stalling, and restore it once pressure clears; preemption flags stop
  serving at a tick boundary,
* a :class:`RuntimeStats` counters object, exported by
  :meth:`ServeRuntime.stats`.

Everything runs on one device (default CUDA; ``device="cpu"`` runs the
plain path): the graph's CSR stays on the device its source built it on,
the walks that make the prompts run there, and so does the model.  A
prompt equals the reference's bitwise for the same ``(seed, rid, graph)``
(``data/prng.py`` is ``jax.random``'s threefry).

Training-side churn rides the same pieces: :meth:`ServeRuntime.corpus`
opens a step-indexed :class:`~repro_torch.data.corpus.WalkCorpus` stream
through the cache, and the corpus cursor gives kill/restart a
bitwise-identical resume.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.cache import _OP_SECTIONS, SourceCache
from ..core.env import resolve_device
from ..core.snapshot import SnapshotError
from ..data import prng
from ..data.corpus import CorpusConfig, WalkCorpus
from ..data.walks import I32, random_walks, walk_from, walk_keys
from ..ft.coordinator import Coordinator, FTConfig
from .engine import Request, ServeEngine


@dataclasses.dataclass
class RuntimeStats:
    """Monotonic counters over the runtime's lifetime."""

    requests: int = 0             # requests completed
    tokens: int = 0               # new tokens decoded
    ticks: int = 0                # engine ticks driven by drain()
    active_ticks: int = 0         # sum of active slots over ticks
    seconds: float = 0.0          # wall time inside drain()
    degrades: int = 0             # straggler-driven admission cuts
    restores: int = 0             # admission width restorations
    resumes: int = 0              # corpus streams opened at step > 0
    corrupt: int = 0              # requests refused on corrupt graphs

    def occupancy(self, batch: int) -> float:
        """Mean fraction of slots busy per tick (0 when never ticked)."""
        return self.active_ticks / (self.ticks * batch) if self.ticks else 0.0

    def tokens_per_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0


class ServeRuntime:
    """Continuous-batching walk-LM server over a snapshot corpus.  The
    model must live on ``device`` (default CUDA)."""

    def __init__(self, cfg, model, *, batch: int = 4, max_seq: int = 64,
                 cache: Optional[SourceCache] = None,
                 coordinator: Optional[Coordinator] = None,
                 ft: Optional[FTConfig] = None,
                 seed: int = 0, prompt_len: int = 8, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cache = cache if cache is not None else SourceCache()
        self.engine = ServeEngine(cfg, model, batch=batch, max_seq=max_seq,
                                  device=self.device)
        self.coord = coordinator or Coordinator(
            ft or FTConfig(straggler_policy="degrade", straggler_factor=4.0,
                           straggler_window=8))
        self.seed = seed
        self.prompt_len = prompt_len
        self._stats = RuntimeStats()
        self._rids = itertools.count()
        self._completed_seen = 0
        self._ok_streak = 0
        # the CSR per live GraphSource handle, on the handle's device: a
        # swapped snapshot reopens as a NEW handle (new id), so stale graphs
        # can never serve a post-swap request; entries are pruned once they
        # outnumber the cache's open-handle bound.
        self._graphs: Dict[int, tuple] = {}

    # -- graph resolution ----------------------------------------------------

    def _graph(self, path: str, **open_kw):
        # an already-quarantined graph fails fast with the structured
        # error (no admission change: the first detection degraded)
        self.cache.check_quarantine(path, _OP_SECTIONS["csr"])
        src = self.cache.get(path, device=self.device, **open_kw)
        ent = self._graphs.get(id(src))
        if ent is None or ent[0] is not src:
            try:
                csr = src.csr()
            except SnapshotError as exc:
                raise self._on_corrupt(path, exc) from exc
            ent = (src, csr.offsets.to(I32), csr.targets.to(I32),
                   int(csr.num_vertices))
            if len(self._graphs) >= 2 * self.cache.capacity:
                self._graphs.clear()
            self._graphs[id(src)] = ent
        return ent

    def _on_corrupt(self, path: str, exc: SnapshotError):
        """First detection of a corrupt graph: quarantine it in the
        cache, degrade admission (the straggler-degrade path -- corrupt
        reads and stragglers are both capacity loss; serving narrows
        instead of stalling), and return the structured error."""
        err = self.cache.report_corrupt(path, exc, op="csr")
        self._stats.corrupt += 1
        if self.coord.observe_fault(f"corrupt graph {path}: {exc}") \
                == "degrade":
            self._degrade_admission()
        return err

    # -- requests ------------------------------------------------------------

    def submit(self, path: str, *, start: Optional[int] = None,
               prompt_len: Optional[int] = None, max_new: int = 8,
               rid: Optional[int] = None, **open_kw) -> Request:
        """Admit one walk-LM request against ``path``.  The prompt is a
        deterministic random walk over the graph as it exists on disk
        *now* (resolved through the cache, so a swapped snapshot serves
        its new contents from this request on).  ``start`` pins the
        walk's first vertex; default start and every neighbor draw are
        pure functions of ``(seed, rid, graph)``."""
        rid = next(self._rids) if rid is None else rid
        n = self.prompt_len if prompt_len is None else int(prompt_len)
        _, offsets, targets, v = self._graph(path, **open_kw)
        key = prng.key(self.seed, device=self.device)
        if start is None:
            walk = random_walks(offsets, targets, key, num_walks=1,
                                length=n, num_vertices=v, walk_offset=rid)
        else:
            walk = walk_from(offsets, targets, walk_keys(key, [rid]),
                             [int(start)], length=n)
        prompt = (walk[0] % self.cfg.vocab_size).cpu().numpy().astype(np.int32)
        req = Request(rid, prompt, max_new)
        self.engine.submit(req)
        return req

    # -- serving loop --------------------------------------------------------

    def _degrade_admission(self) -> None:
        """Halve the engine's admission width (floor 1) -- shared by the
        straggler policy and the corrupt-graph path."""
        eng = self.engine
        self._ok_streak = 0
        new = max(1, eng.max_active // 2)
        if new < eng.max_active:
            eng.max_active = new
            self._stats.degrades += 1

    def _observe(self, dt: float) -> None:
        action = self.coord.observe_step(dt)
        eng = self.engine
        if action == "straggler-degrade":
            self._degrade_admission()
        elif action == "ok" and eng.max_active < eng.batch:
            self._ok_streak += 1
            if self._ok_streak >= self.coord.cfg.straggler_window:
                eng.max_active = min(eng.batch, eng.max_active * 2)
                self._stats.restores += 1
                self._ok_streak = 0

    def tick(self) -> int:
        """One timed engine tick; feeds the straggler policy and the
        counters.  Returns the number of active slots decoded."""
        t0 = time.perf_counter()
        n = self.engine.step()
        dt = time.perf_counter() - t0
        st = self._stats
        st.ticks += 1
        st.active_ticks += n
        st.seconds += dt
        for req in self.engine.completed[self._completed_seen:]:
            st.requests += 1
            st.tokens += len(req.out)
        self._completed_seen = len(self.engine.completed)
        self._observe(dt)
        return n

    def drain(self, max_ticks: Optional[int] = None) -> int:
        """Tick until every submitted request completes (or the
        coordinator flags preemption -- in-flight work stays queued in
        the engine and a fresh ``drain()`` finishes it).  Returns ticks
        run."""
        ticks = 0
        eng = self.engine
        while eng.queue or any(r is not None for r in eng.slots):
            if self.coord.should_stop():
                break
            if max_ticks is not None and ticks >= max_ticks:
                raise RuntimeError(
                    f"ServeRuntime.drain: requests pending after "
                    f"max_ticks={max_ticks}")
            self.tick()
            ticks += 1
        return ticks

    def serve(self, paths, *, max_new: int = 8, **submit_kw) -> List[Request]:
        """Submit one request per path and drain: the sustained-traffic
        entry."""
        reqs = [self.submit(p, max_new=max_new, **submit_kw) for p in paths]
        self.drain()
        return reqs

    # -- training-side corpus ------------------------------------------------

    def corpus(self, path: str, ccfg: CorpusConfig, *, start_step: int = 0,
               **open_kw):
        """A step-indexed walk-batch stream over ``path``, resolved
        through the same mtime-validated cache as requests, on the
        runtime's device.  A ``start_step > 0`` is a resume (counted in
        stats) and continues the stream bitwise-identically."""
        src = self.cache.get(path, device=self.device, **open_kw)
        if start_step:
            self._stats.resumes += 1
        return WalkCorpus(src, ccfg).batches(start_step=start_step)

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The runtime's counters plus the cache's (hits/misses/
        invalidations and the decoded-frame memo of the hot handles)."""
        st = self._stats
        cache = self.cache.stats()
        return {
            "requests": st.requests,
            "tokens": st.tokens,
            "tokens_per_s": round(st.tokens_per_s(), 3),
            "ticks": st.ticks,
            "occupancy": round(st.occupancy(self.engine.batch), 4),
            "max_active": self.engine.max_active,
            "degrades": st.degrades,
            "restores": st.restores,
            "resumes": st.resumes,
            "corrupt_requests": st.corrupt,
            "seconds": round(st.seconds, 6),
            "cache": cache,
        }

    def close(self) -> None:
        self.coord.close()

    def __enter__(self) -> "ServeRuntime":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
