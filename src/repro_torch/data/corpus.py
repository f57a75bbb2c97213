"""Streaming walk corpus: a GraphSource -> step-indexed LM batch pipeline;
the port of ``repro/data/corpus.py``.

    corpus = WalkCorpus(open_graph("web.el"), CorpusConfig(batch=8))
    with corpus.batches(start_step=0) as stream:
        for step, batch in stream:
            ...

Contract (the reference's):

* **Step-indexed and pure**: ``batch_at(step)`` is a pure function of
  ``(CSR, cfg, step)``, so ``batches(start_step=n)`` resumes a killed
  stream with a bitwise-identical continuation.  The cursor
  (``save_cursor``/``load_cursor``) is just the next step index, written
  atomically.
* **Prefetch-threaded**: ``batches()`` builds batch ``n+1`` in a
  background thread (:class:`repro_torch.data.pipeline.Prefetcher`) while
  the consumer runs step ``n``.
* **Degradable**: ``batch_at(step, batch=b)`` rows are a bitwise prefix of
  the full batch (per-walk keying, ``data/walks.py``).

The CSR is resolved once through the source's memo (``source.csr()``) and
pinned on the corpus on the source's device: no batch moves the graph.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from . import prng
from .pipeline import Prefetcher
from .walks import random_walks


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    """Walk-corpus geometry and keying.  Every field participates in the
    determinism contract: same config + same graph => same batch stream."""

    batch: int = 8                    # walks (rows) per batch
    seq: int = 32                     # tokens per row (walk length - 1)
    vocab_size: int = 256             # token ids = vertex ids mod vocab
    seed: int = 99                    # corpus-level PRNG root
    lookahead: int = 2                # prefetch queue depth
    method: Optional[str] = None      # CSR build method (source default)
    rho: int = 4


class WalkCorpus:
    """A deterministic, prefetch-threaded walk-batch stream over one
    :class:`~repro_torch.core.source.GraphSource`; batches are int32
    tensors on the source's device."""

    def __init__(self, source, cfg: CorpusConfig = CorpusConfig()):
        self.source = source
        self.cfg = cfg
        self._offsets = None          # the pinned CSR, resolved lazily
        self._targets = None
        self._num_vertices = 0

    def _csr_arrays(self):
        """The source's CSR tensors, pinned on the corpus (resolved once
        per corpus, not per batch)."""
        if self._offsets is None:
            csr = self.source.csr(method=self.cfg.method, rho=self.cfg.rho)
            self._offsets, self._targets = csr.offsets, csr.targets
            self._num_vertices = int(csr.num_vertices)
        return self._offsets, self._targets, self._num_vertices

    def batch_at(self, step: int, *, batch: Optional[int] = None) -> dict:
        """The walk-LM batch for ``step`` -- pure and memoless.  A smaller
        ``batch`` override returns the bitwise prefix of the full batch's
        rows."""
        offsets, targets, v = self._csr_arrays()
        cfg = self.cfg
        b = cfg.batch if batch is None else int(batch)
        key = prng.fold_in(prng.key(cfg.seed, device=offsets.device), step)
        walks = random_walks(offsets, targets, key, num_walks=b,
                             length=cfg.seq + 1, num_vertices=v)
        toks = walks % cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, start_step: int = 0, *, device=None) -> "BatchStream":
        """Iterate ``(step, batch)`` from ``start_step`` with a lookahead
        thread building (and, with ``device``, moving) the next batch
        while the caller consumes the current one.  Close the stream (or
        use ``with``) to stop the thread."""
        return BatchStream(self, start_step, device=device)


class BatchStream:
    """Iterator over ``(step, batch)`` backed by a prefetch thread.
    ``next_step`` is the resume cursor: checkpoint it after consuming a
    batch and ``batches(start_step=next_step)`` continues the stream
    bitwise-identically."""

    def __init__(self, corpus: WalkCorpus, start_step: int, *, device=None):
        corpus._csr_arrays()          # resolve the CSR before threading
        self.next_step = int(start_step)
        self._pf = Prefetcher(corpus.batch_at, start_step=self.next_step,
                              lookahead=corpus.cfg.lookahead, device=device)

    def __iter__(self):
        return self

    def __next__(self):
        step = self.next_step
        batch = self._pf.get(expect_step=step)
        self.next_step = step + 1
        return step, batch

    def close(self):
        self._pf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -- resume cursor -----------------------------------------------------------

def save_cursor(path: str, step: int) -> None:
    """Durably persist the next step index: tmp + fsync + rename +
    directory fsync, so a preemption mid-write leaves the previous cursor
    intact and the rename itself survives a host crash."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"step": int(step)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def load_cursor(path: str) -> Optional[int]:
    """The persisted next step index, or ``None`` when no cursor exists
    yet (cold start)."""
    try:
        with open(path) as f:
            return int(json.load(f)["step"])
    except FileNotFoundError:
        return None
