"""Binary graph snapshots: the ``.gvel`` container (write once, load many).

The port of ``repro/core/snapshot.py``.  The format is the reference's,
byte for byte (``docs/snapshot-format.md``): a 40-byte little-endian
header, a section table, and page-aligned sections holding the packed
edgelist (``src``/``dst``/optional ``w``) and, optionally, a prebuilt CSR
(``offsets`` ``<i8``, ``indices`` ``<i4``, optional ``weights``).  Version
2 sections may be stored as checksummed frame streams (:mod:`.codecs`).

Files are host bytes, so reading and writing stay numpy.  What the port
adds is where the products go:

* :meth:`_Section.tensor` moves a whole section to the caller's device in
  chunks of a few MiB.  On CUDA each chunk is read from the page cache
  (or, for a compressed section, decoded frame by frame) into one slot of
  a pinned two-slot ring (:class:`~.blocks.StagingArena`) and copied to
  the card asynchronously on a side stream; the slot is fenced by its
  copy's event, so reading chunk *i+1* overlaps the copy of chunk *i*.
  Nothing of the section stays decoded on the host.  On the CPU the
  chunks land in a tensor that owns its memory.
* Point reads (:meth:`Snapshot.csr_rows`, ``neighbors``, ``degree``)
  slice the section on the host through :meth:`_Section.get_slice`, which
  decodes only the frames the byte span overlaps (memoized per frame up
  to ``FRAME_CACHE_BYTES`` a section, least recently used first out), and
  copy the small result to the device.  ``GraphSource`` serves them from
  a snapshot it keeps open, so the memo lives as long as the handle.

Compressed sections decode lazily, at first use: a CSR load of a
both-sections snapshot never decodes an edgelist frame, and corruption in
a section surfaces as :class:`SnapshotError` naming it at first access.

:class:`SnapshotEngine` plugs the whole-section loads into the loader
registry under ``"snapshot"``.
"""
from __future__ import annotations

import os
import struct
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import codecs
from .blocks import StagingArena, mmap_bytes
from .env import resolve_device
from .types import CSR, EdgeList

MAGIC = b"GVELSNAP"
VERSION = 1                        # written when no v2 feature is used
VERSION_COMPRESSED = 2             # v2: section table entries carry a codec
SUPPORTED_VERSIONS = (VERSION, VERSION_COMPRESSED)
HEADER_FMT = "<8sIIQQII"           # magic, version, flags, V, E, n_sections, reserved
HEADER_LEN = struct.calcsize(HEADER_FMT)       # 40
SECTION_FMT = "<IIQQ"              # id, dtype code, byte offset, byte length
SECTION_LEN = struct.calcsize(SECTION_FMT)     # 24
# v2 entry: v1 fields + codec id, reserved (0), uncompressed byte length
SECTION_FMT_V2 = "<IIQQIIQ"
SECTION_LEN_V2 = struct.calcsize(SECTION_FMT_V2)   # 40
ALIGN = 4096                       # sections are page-aligned

# Per-section byte budget of the decoded-frame memo on the point-read path
# (get_slice); least recently used frames are dropped past it.  Tests may
# lower this module global.
FRAME_CACHE_BYTES = 32 * 1024 * 1024

# bytes per chunk of a section's move to the device (one pinned slot)
CHUNK_BYTES = 8 * 1024 * 1024
# threads decoding the frames of one chunk (zlib and zstd release the GIL)
_DECODE_WORKERS = min(8, os.cpu_count() or 1)

FLAG_WEIGHTED = 1 << 0
FLAG_EDGELIST = 1 << 1
FLAG_CSR = 1 << 2

SEC_SRC = 1
SEC_DST = 2
SEC_EDGE_WEIGHTS = 3
SEC_CSR_OFFSETS = 4
SEC_CSR_INDICES = 5
SEC_CSR_WEIGHTS = 6

SECTION_NAMES = {
    SEC_SRC: "src",
    SEC_DST: "dst",
    SEC_EDGE_WEIGHTS: "edge_weights",
    SEC_CSR_OFFSETS: "csr_offsets",
    SEC_CSR_INDICES: "csr_indices",
    SEC_CSR_WEIGHTS: "csr_weights",
}

# dtype codes are explicit little-endian; a snapshot means the same bytes
# on every host
_CODE_TO_DTYPE = {
    1: np.dtype("<i4"),
    2: np.dtype("<i8"),
    3: np.dtype("<f4"),
    4: np.dtype("<f8"),
    5: np.dtype("u1"),
}
_KIND_TO_CODE = {("i", 4): 1, ("i", 8): 2, ("f", 4): 3, ("f", 8): 4,
                 ("u", 1): 5}
_TORCH_DTYPE = {1: torch.int32, 2: torch.int64, 3: torch.float32,
                4: torch.float64, 5: torch.uint8}


class SnapshotError(ValueError):
    """Malformed, truncated, or unsupported ``.gvel`` file.

    ``section`` names the damaged section (``"csr_indices"``, ...) when the
    failure is a payload decode, and is ``None`` for structural damage
    (bad magic, truncated table)."""

    def __init__(self, message: str, *, section: Optional[str] = None):
        super().__init__(message)
        self.section = section


def _dtype_code(dtype: np.dtype) -> int:
    try:
        return _KIND_TO_CODE[(dtype.kind, dtype.itemsize)]
    except KeyError:
        raise SnapshotError(f"unsupported section dtype {dtype}") from None


def _align(off: int) -> int:
    return -(-off // ALIGN) * ALIGN


def is_snapshot(path: str) -> bool:
    """Cheap magic sniff; False for missing/short/non-snapshot files."""
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


def peek_header(path: str) -> Tuple[int, int, int, int, int]:
    """Validate and return (version, flags, V, E, section_count) without
    touching any section bytes."""
    size = os.path.getsize(path)
    if size < HEADER_LEN:
        raise SnapshotError(f"{path}: truncated header ({size} bytes)")
    with open(path, "rb") as f:
        hdr = f.read(HEADER_LEN)
    magic, version, flags, v, e, count, reserved = struct.unpack(HEADER_FMT, hdr)
    if magic != MAGIC:
        raise SnapshotError(f"{path}: bad magic {magic!r}, not a .gvel snapshot")
    if version not in SUPPORTED_VERSIONS:
        raise SnapshotError(
            f"{path}: unsupported snapshot version {version} "
            f"(this reader supports {SUPPORTED_VERSIONS})")
    if reserved != 0:
        raise SnapshotError(f"{path}: nonzero reserved header field")
    return version, flags, v, e, count


def peek_table(path: str):
    """Header + section-table metadata without touching payload bytes:
    ``(version, flags, V, E, entries)``, each entry ``(sid, dtype_code,
    offset, nbytes, codec_id, raw_nbytes)``."""
    version, flags, v, e, count = peek_header(path)
    v2 = version == VERSION_COMPRESSED
    entry_fmt = SECTION_FMT_V2 if v2 else SECTION_FMT
    entry_len = SECTION_LEN_V2 if v2 else SECTION_LEN
    table_len = count * entry_len
    with open(path, "rb") as f:
        f.seek(HEADER_LEN)
        raw = f.read(table_len)
    if len(raw) < table_len:
        raise SnapshotError(
            f"{path}: truncated section table "
            f"({HEADER_LEN + len(raw)} < {HEADER_LEN + table_len} bytes)")
    entries = []
    for i in range(count):
        if v2:
            sid, code, off, nbytes, codec_id, _rsvd, raw_nbytes = \
                struct.unpack_from(entry_fmt, raw, i * entry_len)
        else:
            sid, code, off, nbytes = struct.unpack_from(entry_fmt, raw,
                                                        i * entry_len)
            codec_id, raw_nbytes = 0, nbytes
        entries.append((sid, code, off, nbytes, codec_id, raw_nbytes))
    return version, flags, v, e, entries


def section_frame_counts(path: str) -> Dict[str, int]:
    """``{section_name: frame_count}`` for a snapshot's compressed sections
    (empty for v1 / all-raw files), by a walk over the 12-byte frame
    headers: nothing is decompressed."""
    _version, _flags, _v, _e, entries = peek_table(path)
    out: Dict[str, int] = {}
    data = None
    for sid, _code, off, nbytes, codec_id, _raw in entries:
        if codec_id == 0 or sid not in SECTION_NAMES:
            continue
        if data is None:
            data = mmap_bytes(path)
        out[SECTION_NAMES[sid]] = codecs.count_frames(
            data[off:off + nbytes], context=f"{path} section {sid}")
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _host(x, dtype: str, n: Optional[int] = None) -> np.ndarray:
    """A tensor or array (its first ``n`` elements) as a contiguous
    little-endian host array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x[:n] if n is not None else x
        x = x.detach().cpu().numpy()
    else:
        x = np.asarray(x)[:n] if n is not None else np.asarray(x)
    return np.ascontiguousarray(x, dtype=dtype)


def save_snapshot(
    path: str,
    *,
    edgelist: Optional[EdgeList] = None,
    csr: Optional[CSR] = None,
    compress: Optional[str] = None,
    compress_level: Optional[int] = None,
    frame_beta: Optional[int] = None,
) -> None:
    """Write a ``.gvel`` snapshot from loader outputs (tensors on any
    device, or numpy arrays).

    At least one of ``edgelist`` / ``csr`` is required; with both the file
    serves every product (a CSR load takes the embedded CSR and skips the
    build).  A CSR must be global (``row_start == 0``).  ``compress`` names
    a registered codec; the sections are then frame streams and the file
    is version 2.  The bytes are the reference's for the same inputs,
    codec and level.
    """
    if edgelist is None and csr is None:
        raise ValueError("save_snapshot needs an edgelist, a csr, or both")

    sections: List[Tuple[int, np.ndarray]] = []
    flags = 0
    num_vertices = None
    num_edges = None

    if edgelist is not None:
        n = int(edgelist.num_edges)
        sections += [(SEC_SRC, _host(edgelist.src, "<i4", n)),
                     (SEC_DST, _host(edgelist.dst, "<i4", n))]
        if edgelist.weights is not None:
            sections.append((SEC_EDGE_WEIGHTS,
                             _host(edgelist.weights, "<f4", n)))
            flags |= FLAG_WEIGHTED
        flags |= FLAG_EDGELIST
        num_vertices = int(edgelist.num_vertices)
        num_edges = n

    if csr is not None:
        if csr.row_start != 0:
            raise ValueError("save_snapshot: shard-local CSR (row_start != 0) "
                             "cannot be snapshotted")
        offsets = _host(csr.offsets, "<i8")
        indices = _host(csr.targets, "<i4")
        if offsets.shape[0] != csr.num_vertices + 1:
            raise ValueError(
                f"save_snapshot: offsets length {offsets.shape[0]} != "
                f"num_vertices + 1 ({csr.num_vertices + 1})")
        if num_vertices is not None and num_vertices != csr.num_vertices:
            raise ValueError(
                f"save_snapshot: edgelist has {num_vertices} vertices, "
                f"csr has {csr.num_vertices}")
        if num_edges is not None and num_edges != indices.shape[0]:
            raise ValueError(
                f"save_snapshot: edgelist has {num_edges} edges, "
                f"csr has {indices.shape[0]} -- snapshot one graph")
        csr_weighted = csr.weights is not None
        if edgelist is not None and csr_weighted != (edgelist.weights is not None):
            raise ValueError("save_snapshot: edgelist/csr weight presence "
                             "mismatch")
        sections += [(SEC_CSR_OFFSETS, offsets), (SEC_CSR_INDICES, indices)]
        if csr_weighted:
            sections.append((SEC_CSR_WEIGHTS, _host(csr.weights, "<f4")))
            flags |= FLAG_WEIGHTED
        flags |= FLAG_CSR
        num_vertices = int(csr.num_vertices)
        if num_edges is None:
            num_edges = int(indices.shape[0])

    if compress is not None:
        codec = codecs.get_codec(compress)
        beta = codecs.DEFAULT_FRAME_BETA if frame_beta is None else frame_beta
        version = VERSION_COMPRESSED
        payloads = [(sid, arr,
                     codecs.compress_frames(arr.view(np.uint8), codec,
                                            level=compress_level,
                                            frame_beta=beta))
                    for sid, arr in sections]
    else:
        codec = None
        version = VERSION
        payloads = [(sid, arr, None) for sid, arr in sections]

    # layout: header, table, then page-aligned sections in table order
    entry_len = SECTION_LEN if version == VERSION else SECTION_LEN_V2
    table = []
    off = HEADER_LEN + len(sections) * entry_len
    for sid, arr, comp in payloads:
        off = _align(off)
        stored = arr.nbytes if comp is None else len(comp)
        if version == VERSION:
            table.append((sid, _dtype_code(arr.dtype), off, stored))
        else:
            table.append((sid, _dtype_code(arr.dtype), off, stored,
                          codec.codec_id, 0, arr.nbytes))
        off += stored
    end = off

    with open(path, "wb") as f:
        f.write(struct.pack(HEADER_FMT, MAGIC, version, flags,
                            num_vertices, num_edges, len(sections), 0))
        fmt = SECTION_FMT if version == VERSION else SECTION_FMT_V2
        for entry in table:
            f.write(struct.pack(fmt, *entry))
        for (sid, arr, comp), entry in zip(payloads, table):
            f.seek(entry[2])
            f.write(memoryview(arr.view(np.uint8)) if comp is None else comp)
        # zero-length tail sections may point past the last written byte;
        # extend so every (offset, offset + nbytes) range is in-file
        f.truncate(end)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Section:
    """One section's payload cell.

    Uncompressed sections are zero-copy mmap views from the start.
    Compressed sections hold only their frame stream's byte range:
    :meth:`get` decodes (and checksums) the whole payload on the host and
    memoizes it, :meth:`get_slice` decodes only the frames an element range
    overlaps, and :meth:`tensor` moves the section to a device chunk by
    chunk without keeping it on the host.  Decodes are lock-guarded.
    """

    __slots__ = ("path", "sid", "dtype", "code", "offset", "nbytes", "codec",
                 "raw_nbytes", "_data", "_arr", "_lock", "_ftable",
                 "_frames", "_frames_bytes", "_frame_hits",
                 "_frame_evictions")

    def __init__(self, path, sid, code, offset, nbytes, codec, raw_nbytes,
                 data):
        self.path = path
        self.sid = sid
        self.code = code
        self.dtype = _CODE_TO_DTYPE[code]
        self.offset = offset
        self.nbytes = nbytes
        self.codec = codec               # None = stored (codec_id 0)
        self.raw_nbytes = raw_nbytes
        self._data = data
        self._arr = (data[offset:offset + nbytes].view(self.dtype)
                     if codec is None else None)
        self._lock = threading.Lock()
        self._ftable = None              # codecs.FrameEntry seek index
        # frame idx -> raw bytes, LRU order, bounded by FRAME_CACHE_BYTES
        self._frames: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._frames_bytes = 0
        self._frame_hits = 0
        self._frame_evictions = 0

    @property
    def name(self) -> Optional[str]:
        return SECTION_NAMES.get(self.sid)

    @property
    def context(self) -> str:
        return f"{self.path} section {self.sid}"

    @property
    def length(self) -> int:
        """Element count, known from the table alone (no payload)."""
        return self.raw_nbytes // self.dtype.itemsize

    @property
    def decoded(self) -> bool:
        return self._arr is not None

    def _payload(self) -> np.ndarray:
        return self._data[self.offset:self.offset + self.nbytes]

    def get(self) -> np.ndarray:
        """The whole section as a read-only host array, memoized."""
        if self._arr is None:
            with self._lock:
                if self._arr is not None:       # decoded while waiting
                    return self._arr
                try:
                    # attribute lookup at call time: tests instrument it
                    arr = codecs.decompress_frames(
                        self._payload(), self.raw_nbytes, self.codec,
                        context=self.context)
                except ValueError as exc:
                    raise SnapshotError(str(exc), section=self.name) from None
                arr.flags.writeable = False
                self._frames.clear()         # full decode supersedes frames
                self._frames_bytes = 0
                self._arr = arr.view(self.dtype)
        return self._arr

    def _frame_table(self):
        if self._ftable is None:
            try:
                self._ftable = codecs.frame_table(self._payload(),
                                                  context=self.context)
            except ValueError as exc:
                raise SnapshotError(str(exc), section=self.name) from None
        return self._ftable

    def _decode(self, entry) -> np.ndarray:
        try:
            return np.frombuffer(codecs.decode_frame(
                self._payload(), entry, self.codec, context=self.context),
                np.uint8)
        except ValueError as exc:
            raise SnapshotError(str(exc), section=self.name) from None

    def _touched(self, byte_lo: int, byte_hi: int) -> list:
        entries = self._frame_table()
        touched = codecs.frames_overlapping(entries, byte_lo, byte_hi)
        if not touched or touched[0].raw_off > byte_lo \
                or touched[-1].raw_end < byte_hi:
            raise SnapshotError(
                f"{self.context}: frames cover {self.raw_nbytes} bytes "
                f"but byte range [{byte_lo}, {byte_hi}) is not fully framed",
                section=self.name)
        return touched

    def get_slice(self, lo: int, hi: int) -> np.ndarray:
        """Elements ``[lo, hi)`` as a read-only host array: a zero-copy
        sub-view of an uncompressed (or fully decoded) section, else
        assembled from only the frames the byte span overlaps, each
        decoded frame memoized (LRU, ``FRAME_CACHE_BYTES`` a section)."""
        if not 0 <= lo <= hi <= self.length:
            raise IndexError(
                f"{self.context}: element range [{lo}, {hi}) outside "
                f"[0, {self.length})")
        if self._arr is not None:
            return self._arr[lo:hi]
        isz = self.dtype.itemsize
        byte_lo, byte_hi = lo * isz, hi * isz
        if byte_lo == byte_hi:
            return np.empty(0, self.dtype)
        with self._lock:
            if self._arr is not None:           # raced with a full get()
                return self._arr[lo:hi]
            touched = self._touched(byte_lo, byte_hi)
            parts = []
            for entry in touched:
                raw = self._frames.get(entry.index)
                if raw is None:
                    raw = self._decode(entry)
                    self._frames[entry.index] = raw
                    self._frames_bytes += raw.nbytes
                    # ``parts`` keeps this read's frames alive, so an
                    # eviction only forgets, never corrupts, the slice
                    cap = max(int(FRAME_CACHE_BYTES), 0)
                    while self._frames_bytes > cap and len(self._frames) > 1:
                        _, old = self._frames.popitem(last=False)
                        self._frames_bytes -= old.nbytes
                        self._frame_evictions += 1
                else:
                    self._frame_hits += 1
                    self._frames.move_to_end(entry.index)
                parts.append(raw)
            base = touched[0].raw_off
            buf = parts[0] if len(parts) == 1 else np.concatenate(parts)
            out = buf[byte_lo - base:byte_hi - base].view(self.dtype)
            out.flags.writeable = False
            return out

    # -- the whole section on a device ---------------------------------------

    def _chunks(self) -> list:
        """``(byte_lo, byte_hi, frames-or-None)`` pieces of at most
        ``CHUNK_BYTES`` (or one frame) covering the section."""
        n = self.raw_nbytes
        if self._arr is not None:
            return [(lo, min(lo + CHUNK_BYTES, n), None)
                    for lo in range(0, n, CHUNK_BYTES)]
        entries = self._touched(0, n) if n else []
        out, group = [], []
        for e in entries:
            if group and e.raw_end - group[0].raw_off > CHUNK_BYTES:
                out.append((group[0].raw_off, group[-1].raw_end, group))
                group = []
            group.append(e)
        if group:
            out.append((group[0].raw_off, group[-1].raw_end, group))
        return out

    def _fill(self, dst: np.ndarray, lo: int, hi: int, frames, f,
              pool) -> None:
        """Section bytes ``[lo, hi)`` into ``dst``: a read from the open
        file ``f`` (stored sections), a copy of the memo, or the frames
        decoded in parallel on ``pool`` (compressed sections)."""
        if frames is None and self.codec is None:
            f.seek(self.offset + lo)
            got = f.readinto(memoryview(dst))
            if got != hi - lo:
                raise SnapshotError(
                    f"{self.context}: short read at byte {lo} ({got} of "
                    f"{hi - lo} bytes)", section=self.name)
        elif frames is None:
            dst[:] = self._arr.view(np.uint8)[lo:hi]
        else:
            def one(e):
                dst[e.raw_off - lo:e.raw_end - lo] = self._decode(e)
            list(pool.map(one, frames))

    def tensor(self, device: torch.device) -> torch.Tensor:
        """The whole section as a new tensor on ``device`` that owns its
        memory.  On CUDA the chunks pass through a pinned two-slot ring
        and are copied asynchronously on a side stream, each slot fenced by
        its copy's event; the call returns once the last copy is done."""
        out = torch.empty(self.raw_nbytes, dtype=torch.uint8, device=device)
        chunks = self._chunks()
        with open(self.path, "rb") as f, \
                ThreadPoolExecutor(_DECODE_WORKERS) as pool:
            if device.type == "cpu":
                host = out.numpy()
                for lo, hi, frames in chunks:
                    self._fill(host[lo:hi], lo, hi, frames, f, pool)
            elif chunks:
                arena = StagingArena(max(hi - lo for lo, hi, _ in chunks),
                                     pin=True)
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                copied = None
                try:
                    for i, (lo, hi, frames) in enumerate(chunks):
                        slot = arena.slot(i).take(hi - lo)  # waits on fence
                        self._fill(slot, lo, hi, frames, f, pool)
                        with torch.cuda.stream(side):
                            out[lo:hi].copy_(torch.from_numpy(slot),
                                             non_blocking=True)
                            copied = torch.cuda.Event()
                            copied.record(side)
                        arena.fence(i, copied)
                finally:
                    torch.cuda.current_stream(device).wait_stream(side)
                    if copied is not None:
                        copied.synchronize()    # the ring outlives no copy
        return out.view(_TORCH_DTYPE[self.code])


class Snapshot:
    """A validated, mmap-backed handle on a ``.gvel`` file.

    Structure (header, table, section presence and lengths) is validated
    at open without touching payload bytes; payloads are read lazily, per
    section.  The ``src``/``dst``/... properties are host arrays (the
    reference's); :meth:`edgelist`, :meth:`csr`, :meth:`csr_rows` and
    :meth:`neighbors` return tensors on a device.  Corruption inside a
    compressed payload surfaces at first access of that section, as
    :class:`SnapshotError`; :meth:`materialize` checks every section.
    """

    def __init__(self, path: str, version: int, flags: int,
                 num_vertices: int, num_edges: int,
                 sections: "dict[int, _Section]"):
        self.path = path
        self.version = version
        self.flags = flags
        self.num_vertices = num_vertices
        self.num_edges = num_edges
        self._sections = sections

    def _get(self, sid: int) -> Optional[np.ndarray]:
        cell = self._sections.get(sid)
        if cell is None:
            return None
        first = not cell.decoded
        arr = cell.get()
        if first and sid == SEC_CSR_OFFSETS:
            try:
                self._check_csr_offsets(arr)
            except SnapshotError:
                # a memoized-but-inconsistent array is never served again
                cell._arr = None
                raise
        return arr

    def _check_csr_offsets(self, arr) -> None:
        if arr.shape[0] and int(arr[-1]) != self.num_edges:
            raise SnapshotError(
                f"{self.path}: csr offsets end at {int(arr[-1])}, "
                f"header says {self.num_edges} edges",
                section="csr_offsets")

    def _tensor(self, sid: int, device) -> Optional[torch.Tensor]:
        cell = self._sections.get(sid)
        if cell is None:
            return None
        out = cell.tensor(resolve_device(device))
        if sid == SEC_CSR_OFFSETS:
            self._check_csr_offsets(out)
        return out

    # lazy host payloads -------------------------------------------------------
    @property
    def src(self) -> Optional[np.ndarray]:
        return self._get(SEC_SRC)

    @property
    def dst(self) -> Optional[np.ndarray]:
        return self._get(SEC_DST)

    @property
    def edge_weights(self) -> Optional[np.ndarray]:
        return self._get(SEC_EDGE_WEIGHTS)

    @property
    def csr_offsets(self) -> Optional[np.ndarray]:
        return self._get(SEC_CSR_OFFSETS)

    @property
    def csr_indices(self) -> Optional[np.ndarray]:
        return self._get(SEC_CSR_INDICES)

    @property
    def csr_weights(self) -> Optional[np.ndarray]:
        return self._get(SEC_CSR_WEIGHTS)

    # ------------------------------------------------------------------------
    @property
    def weighted(self) -> bool:
        return bool(self.flags & FLAG_WEIGHTED)

    @property
    def has_edgelist(self) -> bool:
        return bool(self.flags & FLAG_EDGELIST)

    @property
    def has_csr(self) -> bool:
        return bool(self.flags & FLAG_CSR)

    def decoded_sections(self) -> "list[int]":
        """Section ids whose payloads are held on the host (every stored
        section: views cost nothing)."""
        return sorted(sid for sid, c in self._sections.items() if c.decoded)

    def section_codecs(self) -> "list[str]":
        """Distinct codec names used by compressed sections."""
        return sorted({c.codec.name for c in self._sections.values()
                       if c.codec is not None})

    def frame_cache_stats(self) -> Dict[str, int]:
        """Decoded-frame memo counters summed over sections: ``frames`` /
        ``bytes`` held now, ``hits`` and ``evictions`` since open."""
        out = {"frames": 0, "bytes": 0, "hits": 0, "evictions": 0}
        for c in self._sections.values():
            out["frames"] += len(c._frames)
            out["bytes"] += c._frames_bytes
            out["hits"] += c._frame_hits
            out["evictions"] += c._frame_evictions
        return out

    def materialize(self) -> "Snapshot":
        """Decode (and checksum) every section on the host; returns self."""
        for sid in sorted(self._sections):
            self._get(sid)
        return self

    def _weighted_arg(self, weighted: Optional[bool]) -> bool:
        if weighted is None:
            return self.weighted
        if weighted and not self.weighted:
            raise SnapshotError(
                f"{self.path}: weighted read requested but snapshot is "
                f"unweighted")
        return bool(weighted)

    def edgelist(self, device=None, *,
                 weighted: Optional[bool] = None) -> EdgeList:
        """The edgelist sections as tensors on ``device`` (default CUDA);
        the weights section is read only when the result carries weights."""
        if not self.has_edgelist:
            raise SnapshotError(f"{self.path}: CSR-only snapshot has no "
                                f"edgelist sections")
        w = (self._tensor(SEC_EDGE_WEIGHTS, device)
             if self._weighted_arg(weighted) else None)
        return EdgeList(self._tensor(SEC_SRC, device),
                        self._tensor(SEC_DST, device), w, self.num_edges,
                        self.num_vertices)

    def csr(self, device=None, *, weighted: Optional[bool] = None) -> CSR:
        """The embedded CSR as tensors on ``device`` (default CUDA)."""
        if not self.has_csr:
            raise SnapshotError(f"{self.path}: snapshot has no CSR sections")
        w = (self._tensor(SEC_CSR_WEIGHTS, device)
             if self._weighted_arg(weighted) else None)
        return CSR(self._tensor(SEC_CSR_OFFSETS, device),
                   self._tensor(SEC_CSR_INDICES, device), w,
                   self.num_vertices)

    # selective reads --------------------------------------------------------
    def _offsets_slice(self, lo: int, hi: int) -> np.ndarray:
        """``offsets[lo:hi+1]`` by partial decode, checked monotone and
        within ``[0, num_edges]``."""
        off = self._sections[SEC_CSR_OFFSETS].get_slice(lo, hi + 1)
        bad = False
        if off.size:
            if int(off[0]) < 0 or int(off[-1]) > self.num_edges:
                bad = True
            elif off.size <= 4:      # point reads: plain Python is cheaper
                prev = int(off[0])
                for x in off[1:]:
                    x = int(x)
                    if x < prev:
                        bad = True
                        break
                    prev = x
            else:
                bad = bool(np.any(np.diff(off) < 0))
        if bad:
            raise SnapshotError(
                f"{self.path}: csr offsets [{lo}, {hi}] are inconsistent "
                f"(non-monotone or outside [0, {self.num_edges}])")
        return off

    def csr_rows(self, lo: int, hi: int, *, weighted: Optional[bool] = None,
                 device=None) -> CSR:
        """The CSR restricted to vertex rows ``[lo, hi)`` on ``device``,
        reading only the bytes those rows span (compressed sections decode
        only the frames the span overlaps).  A row-local CSR: ``offsets``
        rebased to 0, ``row_start=lo``, global ``num_vertices``."""
        if not self.has_csr:
            raise SnapshotError(f"{self.path}: snapshot has no CSR sections")
        if not 0 <= lo <= hi <= self.num_vertices:
            raise IndexError(
                f"{self.path}: row range [{lo}, {hi}) outside "
                f"[0, {self.num_vertices})")
        weighted = self._weighted_arg(weighted)
        device = resolve_device(device)
        off = self._offsets_slice(lo, hi)
        e_lo = int(off[0]) if off.size else 0
        e_hi = int(off[-1]) if off.size else 0
        targets = self._sections[SEC_CSR_INDICES].get_slice(e_lo, e_hi)
        w = (self._sections[SEC_CSR_WEIGHTS].get_slice(e_lo, e_hi)
             if weighted else None)

        def put(a):
            return None if a is None else torch.from_numpy(
                np.array(a)).to(device)
        return CSR(put(off - np.int64(e_lo)), put(targets), put(w),
                   self.num_vertices, row_start=lo)

    def neighbors(self, u: int, *, weighted: bool = False, device=None):
        """Vertex ``u``'s neighbor ids (and weights when asked) on
        ``device``, decoding only the frames the row spans."""
        row = self.csr_rows(int(u), int(u) + 1, weighted=weighted,
                            device=device)
        return (row.targets, row.weights) if weighted else row.targets

    def degree(self, u: int) -> int:
        """Out-degree of ``u``: two offset elements (at most the offset
        frames they fall in)."""
        if not self.has_csr:
            raise SnapshotError(f"{self.path}: snapshot has no CSR sections")
        if not 0 <= int(u) < self.num_vertices:
            raise IndexError(f"{self.path}: vertex {u} outside "
                             f"[0, {self.num_vertices})")
        off = self._offsets_slice(int(u), int(u) + 1)
        return int(off[1]) - int(off[0])


def read_snapshot(path: str, *, eager: bool = True) -> Snapshot:
    """mmap + validate a ``.gvel`` file.

    Header, table, section presence and element counts are validated here
    without reading payload bytes.  ``eager=True`` also decodes and
    checksums every compressed section on the host before returning;
    ``eager=False`` leaves each to its first access.
    """
    version, flags, num_vertices, num_edges, count = peek_header(path)
    size = os.path.getsize(path)
    v2 = version == VERSION_COMPRESSED
    entry_fmt = SECTION_FMT_V2 if v2 else SECTION_FMT
    entry_len = SECTION_LEN_V2 if v2 else SECTION_LEN
    table_end = HEADER_LEN + count * entry_len
    if size < table_end:
        raise SnapshotError(
            f"{path}: truncated section table ({size} < {table_end} bytes)")
    data = mmap_bytes(path)
    raw = data[HEADER_LEN:table_end].tobytes()

    cells: dict = {}
    for i in range(count):
        if v2:
            sid, code, off, nbytes, codec_id, rsvd, raw_nbytes = \
                struct.unpack_from(entry_fmt, raw, i * entry_len)
            if rsvd != 0:
                raise SnapshotError(f"{path}: section {sid} has nonzero "
                                    f"reserved table field")
        else:
            sid, code, off, nbytes = struct.unpack_from(entry_fmt, raw,
                                                        i * entry_len)
            codec_id, raw_nbytes = 0, nbytes
        if sid not in SECTION_NAMES:
            continue                    # forward compat: skip unknown sections
        if code not in _CODE_TO_DTYPE:
            raise SnapshotError(f"{path}: section {sid} has unknown dtype "
                                f"code {code}")
        dtype = _CODE_TO_DTYPE[code]
        if off % ALIGN:
            raise SnapshotError(f"{path}: section {sid} offset {off} is not "
                                f"{ALIGN}-byte aligned")
        if off + nbytes > size:
            raise SnapshotError(
                f"{path}: truncated -- section {sid} spans "
                f"[{off}, {off + nbytes}) but file is {size} bytes")
        if raw_nbytes % dtype.itemsize:
            raise SnapshotError(f"{path}: section {sid} length {raw_nbytes} "
                                f"is not a multiple of {dtype.itemsize}")
        if codec_id == 0:
            if raw_nbytes != nbytes:
                raise SnapshotError(
                    f"{path}: uncompressed section {sid} declares "
                    f"{raw_nbytes} raw bytes but stores {nbytes}")
            codec = None
        else:
            # the codec is table metadata: a file needing an uninstalled
            # codec fails at open
            try:
                codec = codecs.codec_for_id(codec_id)
            except ValueError as exc:
                raise SnapshotError(f"{path}: section {sid}: {exc}") from None
        cells[sid] = _Section(path, sid, code, off, nbytes, codec,
                              raw_nbytes, data)

    def expect(sid: int, name: str, length: int) -> None:
        cell = cells.get(sid)
        if cell is None:
            raise SnapshotError(f"{path}: flagged {name} section missing")
        if cell.length != length:
            raise SnapshotError(f"{path}: {name} has {cell.length} elements, "
                                f"header implies {length}")

    if flags & FLAG_EDGELIST:
        expect(SEC_SRC, "src", num_edges)
        expect(SEC_DST, "dst", num_edges)
        if flags & FLAG_WEIGHTED:
            expect(SEC_EDGE_WEIGHTS, "edge-weights", num_edges)
    if flags & FLAG_CSR:
        expect(SEC_CSR_OFFSETS, "csr-offsets", num_vertices + 1)
        expect(SEC_CSR_INDICES, "csr-indices", num_edges)
        if flags & FLAG_WEIGHTED:
            expect(SEC_CSR_WEIGHTS, "csr-weights", num_edges)
    snap = Snapshot(path, version, flags, num_vertices, num_edges, cells)
    if flags & FLAG_CSR and cells[SEC_CSR_OFFSETS].decoded:
        # stored offsets are views already: check them at open
        snap._check_csr_offsets(cells[SEC_CSR_OFFSETS].get())
    return snap.materialize() if eager else snap


# ---------------------------------------------------------------------------
# loader engine
# ---------------------------------------------------------------------------

class SnapshotEngine:
    """Zero-parse loader engine over ``.gvel`` snapshots.  ``base`` is
    accepted and ignored (snapshot ids are 0-based); ``offset`` must be 0.
    Products land on ``device`` (default CUDA)."""

    name = "snapshot"

    def __init__(self):
        self._memo: Optional[Tuple[tuple, Snapshot]] = None

    def _snap(self, path: str) -> Snapshot:
        """One lazy open per file per load: the front door probes
        ``read_csr_prebuilt`` / ``num_vertices_hint`` / ``stream`` in turn,
        so memoize on (path, mtime, size), written as one tuple, until the
        load ends (``loader.engine_for_load`` calls :meth:`clear_memo`)."""
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        memo = self._memo
        if memo is not None and memo[0] == key:
            return memo[1]
        snap = read_snapshot(path, eager=False)
        self._memo = (key, snap)
        return snap

    def clear_memo(self) -> None:
        """Drop the memoized snapshot (and what it decoded on the host)."""
        self._memo = None

    @staticmethod
    def _check(snap: Snapshot, *, weighted: bool, offset: int) -> None:
        if offset:
            raise ValueError("snapshot engine does not support offset reads")
        if weighted and not snap.weighted:
            raise SnapshotError(
                f"{snap.path}: weighted load requested but snapshot is "
                f"unweighted")

    def read_edgelist(self, path: str, *, weighted: bool = False,
                      base: int = 0, num_vertices: Optional[int] = None,
                      offset: int = 0, device=None, **kw) -> EdgeList:
        snap = self._snap(path)
        self._check(snap, weighted=weighted, offset=offset)
        # an unweighted read never touches the weights section
        el = snap.edgelist(device, weighted=weighted)
        if num_vertices is not None:
            el.num_vertices = num_vertices
        return el

    def num_vertices_hint(self, path: str) -> int:
        """Header-only |V|: keeps isolated trailing vertices that a max-id
        scan over the edges would drop."""
        return self._snap(path).num_vertices

    def stream(self, path: str, *, weighted: bool = False, base: int = 0,
               offset: int = 0, device=None, **kw):
        """The edgelist sections as the build's feed: ``((src, dst, w,
        total), num_edges)`` with exact-length buffers (no -1 padding) and
        ``total`` an int32 device scalar."""
        snap = self._snap(path)
        self._check(snap, weighted=weighted, offset=offset)
        if snap.num_edges > np.iinfo(np.int32).max:
            # the build's running total and ranks are int32
            raise ValueError(
                f"{path}: {snap.num_edges} edges exceeds int32 for the "
                f"stream + build path; embed a prebuilt CSR in the snapshot")
        if not snap.has_edgelist:
            raise SnapshotError(f"{snap.path}: CSR-only snapshot has no "
                                f"edgelist sections")
        el = snap.edgelist(device, weighted=weighted)
        total = torch.tensor(snap.num_edges, dtype=torch.int32,
                             device=el.src.device)
        return (el.src, el.dst, el.weights, total), snap.num_edges

    def read_csr_prebuilt(self, path: str, *, weighted: bool = False,
                          num_vertices: Optional[int] = None, offset: int = 0,
                          device=None, **kw) -> Optional[CSR]:
        """The embedded CSR on ``device``: no parse, no build.  None (the
        caller streams and builds on the same device) when the snapshot
        has no CSR sections or the caller pinned another |V|."""
        snap = self._snap(path)
        self._check(snap, weighted=weighted, offset=offset)
        if not snap.has_csr or (num_vertices is not None
                                and num_vertices != snap.num_vertices):
            return None
        return snap.csr(device, weighted=weighted)
