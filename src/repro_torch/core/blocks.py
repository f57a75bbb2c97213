"""Host-side block planning and staging (GVEL getBlock).

The port's own copy of ``repro/core/blocks.py`` (plans, staging, block
sources).  The file is cut into uniform ``beta``-byte blocks; block ``b``'s
buffer is the ``overlap + beta`` bytes ``[b*beta - overlap, (b+1)*beta)``,
newline-padded outside the file, and owns the lines whose terminating
newline falls in its last ``beta`` bytes.

Staging differs from the reference in one way: a batch of consecutive
blocks is staged as its **flat span** (``flat_len(nb)`` bytes), which is
what the device copy and the CUDA parse take; :func:`block_view` gives the
reference's ``(nb, buf_len)`` rows over it (rows alias by ``overlap``).
The :class:`StagingArena` ring can hold pinned memory and fences each slot
with the CUDA event of its host-to-device copy, so an asynchronous copy
never reads a slot the prefetch thread is refilling.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import List, Optional

import numpy as np
import torch

from . import faults, tracing

NEWLINE = 10


def mmap_bytes(path: str, offset: int = 0) -> np.ndarray:
    """Memory-map a file as uint8, optionally skipping a header prefix (the
    ``mmap`` fault site)."""
    if faults._ACTIVE is not None:
        faults.inject("mmap", 0, where=path)
    size = os.path.getsize(path)
    if size <= offset:
        return np.zeros(0, np.uint8)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    return data[offset:] if offset else data


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    file_len: int
    beta: int          # owned bytes per block (GVEL: 256 KiB)
    overlap: int       # left context >= max line length
    num_blocks: int
    buf_len: int       # overlap + beta

    @property
    def edge_cap(self) -> int:
        # min parsable line is 4 bytes ("1 2\n"); +2 slack
        return self.buf_len // 4 + 2


def plan_blocks(file_len: int, beta: int = 256 * 1024,
                overlap: int = 64) -> BlockPlan:
    if beta <= overlap:
        raise ValueError(f"beta ({beta}) must exceed overlap ({overlap})")
    num_blocks = max(1, -(-file_len // beta))
    return BlockPlan(file_len, beta, overlap, num_blocks, overlap + beta)


def flat_len(nb: int, plan: BlockPlan) -> int:
    """Bytes of flat staging for ``nb`` consecutive blocks."""
    return (nb - 1) * plan.beta + plan.buf_len


def owned_range(plan: BlockPlan) -> tuple:
    """Buffer-local [start, end) of the owned byte range (uniform)."""
    return plan.overlap, plan.overlap + plan.beta


@dataclasses.dataclass(frozen=True)
class ShardSpan:
    """Shard ``shard``-of-``num_shards``'s contiguous slice of a BlockPlan.

    The split is block-aligned, which makes it safe: a line is owned by the
    block holding its terminating newline, and a block's left context comes
    from its own staged ``overlap`` bytes, so any contiguous block range
    parses exactly the lines it owns.  A framed file's plan has its beta
    forced to the frame size, so the split is frame-aligned too."""

    plan: BlockPlan
    shard: int
    num_shards: int
    block_lo: int      # first owned block (inclusive)
    block_hi: int      # past-the-end block; == block_lo for an empty span

    @property
    def num_blocks(self) -> int:
        return self.block_hi - self.block_lo

    @property
    def byte_lo(self) -> int:
        """First owned file byte (post-header coordinates)."""
        return min(self.block_lo * self.plan.beta, self.plan.file_len)

    @property
    def byte_hi(self) -> int:
        """Past-the-end owned file byte."""
        return min(self.block_hi * self.plan.beta, self.plan.file_len)

    @property
    def edge_cap(self) -> int:
        """Accumulator slots this span needs (over-allocation bound)."""
        return self.num_blocks * self.plan.edge_cap


def shard_plan(plan: BlockPlan, k: int, d: int) -> ShardSpan:
    """Shard ``k``'s span of ``plan`` split into ``d`` contiguous block
    ranges: balanced to within one block, ordered (shard k's bytes precede
    shard k+1's, which keeps the exchanged edges in file order), disjoint
    and covering every block.  Shards past ``num_blocks`` get empty spans."""
    if d < 1:
        raise ValueError(f"num_shards must be >= 1, got {d}")
    if not 0 <= k < d:
        raise ValueError(f"shard index {k} outside [0, {d})")
    nb = plan.num_blocks
    return ShardSpan(plan, k, d, (k * nb) // d, ((k + 1) * nb) // d)


def block_view(flat: np.ndarray, plan: BlockPlan) -> np.ndarray:
    """Read-only ``(nb, buf_len)`` rows over a flat span (rows alias)."""
    nb = (len(flat) - plan.buf_len) // plan.beta + 1
    return np.lib.stride_tricks.as_strided(
        flat, shape=(nb, plan.buf_len), strides=(plan.beta, 1),
        writeable=False)


class StagingArena:
    """A ring of reusable flat staging buffers for one stream.

    ``slot(i)`` is batch ``i``'s buffer handle (slot ``i % slots``, so a
    retried stage of batch ``i`` reuses its own slot).  With ``pin=True``
    the buffers are page-locked, so host-to-device copies from them run
    asynchronously; the consumer then calls :meth:`fence` with the copy's
    CUDA event, and the next ``take`` of that slot waits for the event
    before handing the buffer out for refilling.  Buffers are handed out
    dirty; staging newline-fills the slack it does not overwrite.
    """

    def __init__(self, nbytes: int, slots: int = 2, pin: bool = False):
        self._pin = bool(pin)
        n = max(int(nbytes), 1)
        self._bufs = [self._new(n) for _ in range(max(int(slots), 2))]
        self._fences: List[Optional[object]] = [None] * len(self._bufs)
        self._lock = threading.Lock()

    def _new(self, n: int) -> torch.Tensor:
        if self._pin:
            tracing.count("pinned_bytes_allocated", n)
        return self._alloc(n)

    def _alloc(self, n: int) -> torch.Tensor:
        return torch.full((n,), NEWLINE, dtype=torch.uint8,
                          pin_memory=self._pin)

    def _take(self, k: int, nbytes: int) -> np.ndarray:
        with self._lock:
            fence, self._fences[k] = self._fences[k], None
        if fence is not None:
            with tracing.span("gvel.stage.fence"):
                fence.synchronize()
        if self._bufs[k].numel() < nbytes:
            self._bufs[k] = self._new(nbytes)
        return self._bufs[k].numpy()[:nbytes]

    def slot(self, i: int) -> "_Slot":
        return _Slot(self, i % len(self._bufs))

    def fence(self, i: int, event) -> None:
        """Batch ``i``'s slot is read until ``event`` completes."""
        with self._lock:
            self._fences[i % len(self._bufs)] = event


class _Slot:
    """One arena slot with the ``take`` interface staging calls."""

    def __init__(self, arena: StagingArena, k: int):
        self._arena, self._k = arena, k

    def take(self, nbytes: int) -> np.ndarray:
        return self._arena._take(self._k, nbytes)


def _take_flat(nb: int, plan: BlockPlan, arena, filled_lo: int,
               filled_hi: int) -> np.ndarray:
    """Flat staging buffer for ``nb`` blocks; everything outside
    ``[filled_lo, filled_hi)`` is newline-filled."""
    need = flat_len(nb, plan)
    if arena is None:
        return np.full(need, NEWLINE, np.uint8)
    flat = arena.take(need)
    lo = max(min(filled_lo, need), 0)
    hi = max(min(filled_hi, need), lo)
    if lo:
        flat[:lo] = NEWLINE
    if hi < need:
        flat[hi:] = NEWLINE
    return flat


def _consecutive(ids: np.ndarray) -> None:
    if len(ids) > 1 and not np.all(np.diff(ids) == 1):
        raise ValueError(f"staging takes consecutive block ids, got "
                         f"{ids.tolist()}")


def check_line_overlap(view: np.ndarray, plan: BlockPlan, ids: np.ndarray,
                       data_len: int,
                       describe: str = "staged blocks") -> None:
    """Raise ``ValueError`` when a line longer than ``plan.overlap`` bytes
    crosses a block's owned start: that block's left-context window
    ``[b*beta - overlap, b*beta)`` then holds no newline.  Block 0 and
    windows past EOF are exempt (newline padding)."""
    ids = np.asarray(ids, np.int64)
    if len(ids) == 0:
        return
    need = (ids > 0) & (ids * plan.beta < data_len)
    if not need.any():
        return
    ok = (view[:, :plan.overlap] == NEWLINE).any(axis=1)
    bad = need & ~ok
    if bad.any():
        b = int(ids[int(np.argmax(bad))])
        off = b * plan.beta
        raise ValueError(
            f"{describe}: no newline within overlap={plan.overlap} bytes "
            f"before byte offset {off} (block {b}'s owned start) -- a line "
            f"longer than {plan.overlap} bytes crosses the block boundary "
            f"there and would be mis-parsed.  Re-run with a larger "
            f"overlap= (it must exceed the longest line, including "
            f"comments), or strip overlong lines; offsets are relative to "
            f"any header offset skipped at open.")


def stage_blocks(data: np.ndarray, plan: BlockPlan, block_ids: np.ndarray,
                 arena=None, check_lines: bool = False) -> np.ndarray:
    """Flat span of consecutive blocks ``block_ids`` of ``data`` (one
    memcpy into a newline-padded buffer); ``block_view`` of it gives the
    reference's ``(nb, buf_len)`` rows.  ``check_lines=True`` raises on an
    overlong line crossing a block start (:func:`check_line_overlap`)."""
    ids = np.asarray(block_ids, np.int64)
    nb = len(ids)
    if nb == 0:
        return np.zeros(0, np.uint8)
    _consecutive(ids)
    lo = int(ids[0]) * plan.beta - plan.overlap        # may be < 0
    s = max(lo, 0)
    e = min(lo + flat_len(nb, plan), plan.file_len)
    flat = _take_flat(nb, plan, arena, s - lo, e - lo)
    if e > s:
        flat[s - lo:e - lo] = data[s:e]
    if check_lines:
        check_line_overlap(block_view(flat, plan), plan, ids, plan.file_len)
    return flat


# ---------------------------------------------------------------------------
# block sources: where staged bytes come from
# ---------------------------------------------------------------------------

class MemoryBlockSource:
    """Random-access staging over in-memory (usually mmap'd) bytes."""

    def __init__(self, data: np.ndarray):
        self.data = data
        self.length = len(data)

    def stage(self, plan: BlockPlan, block_ids: np.ndarray, arena=None,
              check_lines: bool = False) -> np.ndarray:
        return stage_blocks(self.data, plan, block_ids, arena, check_lines)

    def finish(self) -> None:
        pass


class SequentialBlockSource:
    """Staging over a forward-only stream of byte chunks (decompressed
    input).  ``length`` is the total expected after dropping the first
    ``skip`` bytes.  Batches must come in order with consecutive block ids,
    as the streaming loader asks for them; pending bytes are kept as a
    queue of zero-copy chunk views, so memory stays O(batch).

    A source may cover only a span of the stream (one shard's, in the
    sharded load): ``start`` is the post-skip position of the first chunk
    byte, ``end`` the past-the-end position the source must cover, and
    ``first_block`` the first block ``stage`` is asked for.  ``start`` must
    not exceed ``first_block * beta - overlap``.

    ``finish`` checks coverage: a source whose span reaches the stream end
    drains it and raises ``ValueError`` unless it held exactly ``length``
    bytes (truncated file, lying gzip trailer); a mid-stream span raises
    unless the stream reached ``end``."""

    def __init__(self, chunks, length: int, *, skip: int = 0,
                 start: int = 0, end: Optional[int] = None,
                 first_block: int = 0,
                 describe: str = "byte stream", mismatch_hint: str = ""):
        self._chunks = iter(chunks)
        self.length = max(int(length), 0)
        self._to_skip = skip
        self._start = min(max(int(start), 0), self.length)
        self._end = self.length if end is None else \
            min(max(int(end), self._start), self.length)
        self._describe = describe
        self._hint = mismatch_hint
        self._q: List[np.ndarray] = []   # pending chunk views, in order
        self._q_start = self._start      # stream offset of _q[0][0]
        self._q_len = 0                  # total bytes queued
        self._produced = 0               # post-skip bytes pulled so far
        self._next_block = int(first_block)

    def _pull(self) -> bool:
        chunk = next(self._chunks, None)
        if chunk is None:
            return False
        if self._to_skip:
            drop = min(self._to_skip, len(chunk))
            self._to_skip -= drop
            chunk = chunk[drop:]
        self._produced += len(chunk)
        if len(chunk):
            view = np.frombuffer(chunk, np.uint8)
            self._q.append(view)
            self._q_len += len(view)
        return True

    def stage(self, plan: BlockPlan, block_ids: np.ndarray, arena=None,
              check_lines: bool = False) -> np.ndarray:
        ids = np.asarray(block_ids, np.int64)
        nb = len(ids)
        if nb == 0:
            return np.zeros(0, np.uint8)
        _consecutive(ids)
        if int(ids[0]) != self._next_block:
            raise ValueError(
                f"{self._describe}: sequential source staged out of order "
                f"(got blocks {ids[0]}..{ids[-1]}, expected "
                f"{self._next_block}..)")
        self._next_block = int(ids[-1]) + 1
        lo = int(ids[0]) * plan.beta - plan.overlap          # may be < 0
        hi = min((int(ids[-1]) + 1) * plan.beta, self.length)
        while self._q_start + self._q_len < hi:
            if not self._pull():
                break                 # short stream: pad now, finish() raises
        s = max(lo, 0)
        e = min(hi, self._q_start + self._q_len)
        flat = _take_flat(nb, plan, arena, s - lo, e - lo)
        pos = self._q_start           # walk the queue once, copying spans
        for view in self._q:
            if pos >= e:
                break
            c0, c1 = max(s - pos, 0), min(e - pos, len(view))
            if c1 > c0:
                flat[pos + c0 - lo:pos + c1 - lo] = view[c0:c1]
            pos += len(view)
        # keep only the tail the next batch's overlap needs
        keep_from = max((int(ids[-1]) + 1) * plan.beta - plan.overlap,
                        self._q_start)
        while self._q and self._q_start + len(self._q[0]) <= keep_from:
            dropped = self._q.pop(0)
            self._q_start += len(dropped)
            self._q_len -= len(dropped)
        if self._q and keep_from > self._q_start:
            cut = keep_from - self._q_start
            self._q[0] = self._q[0][cut:]
            self._q_start = keep_from
            self._q_len -= cut
        if check_lines:
            check_line_overlap(block_view(flat, plan), plan, ids,
                               self.length, self._describe)
        return flat

    def finish(self) -> None:
        need = self._end - self._start
        if self._end >= self.length:
            # the span reaches the stream end: drain, demand the exact total
            while self._pull():
                self._q.clear()       # drained bytes are only counted
                self._q_len = 0
            if self._produced != need:
                raise ValueError(
                    f"{self._describe}: stream decompressed to "
                    f"{self._start + self._produced} bytes after the header "
                    f"offset, expected {self.length}{self._hint}")
            return
        # a mid-stream span: demand only that the stream covered it
        while self._produced < need and self._pull():
            self._q.clear()
            self._q_len = 0
        if self._produced < need:
            raise ValueError(
                f"{self._describe}: stream ended at byte "
                f"{self._start + self._produced} (after the header offset), "
                f"before this shard span's end at {self._end}{self._hint}")
