"""Compressed inputs for every loading path: codecs and framed blocks.

The port's own copy of ``repro/core/codecs.py``, byte for byte in its
on-disk formats:

* a **codec registry**: stdlib ``zlib`` always, ``zstd`` registered when
  the ``zstandard`` package imports.  Codecs are named for callers
  (``"zlib:6"``) and numbered for on-disk headers.
* a **frame layer**: a compressed payload is a sequence of independent
  frames, each one ``frame_beta``-sized block of the original bytes with
  its compressed length, uncompressed length and CRC32.  The frame headers
  are a seek index (:func:`frame_table`), so a partial read decodes only
  the frames it overlaps (:func:`decode_frame`).  The same frame stream is
  the payload of compressed ``.gvel`` v2 sections (:mod:`.snapshot`).
* a **framed file container** (magic ``GVELFRMD``) for standalone
  compressed text, and gzip through the stdlib.  Both are sniffed by
  magic, never by extension.

:func:`open_block_source` feeds the streaming loader: raw files are a
random-access mmap source, gzip and framed files a sequential source whose
chunks are decompressed in the loader's prefetch thread; framed files force
the plan's block size to ``frame_beta``, so one frame is decompressed per
block staged.  Every decompression checks frame checksums and declared
lengths and raises ``ValueError`` on a mismatch.  Frame decodes are the
``frame`` fault site, and every block source is wrapped for the ``block``
site (:mod:`.faults`).  :func:`open_shard_block_source` gives one shard of
the sharded load a source over only its span of blocks.
"""
from __future__ import annotations

import dataclasses
import gzip
import io
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from . import faults as _faults
from .blocks import MemoryBlockSource, SequentialBlockSource, mmap_bytes

# codec id 0 is reserved for "stored" (no compression) in on-disk headers
CODEC_RAW = 0

FRAME_HDR_FMT = "<III"            # comp_len, raw_len, crc32(raw payload)
FRAME_HDR_LEN = struct.calcsize(FRAME_HDR_FMT)          # 12

FRAMED_MAGIC = b"GVELFRMD"
FRAMED_VERSION = 1
# magic, version, codec_id, frame_beta, orig_len, frame_count, reserved
FRAMED_HDR_FMT = "<8sIIQQII"
FRAMED_HDR_LEN = struct.calcsize(FRAMED_HDR_FMT)        # 40

GZIP_MAGIC = b"\x1f\x8b"

DEFAULT_FRAME_BETA = 256 * 1024   # GVEL's beta: one frame per staging block

# decompression chunk pulled per prefetch-thread step for gzip streams
_GZ_CHUNK = 256 * 1024

# threads compressing the frames of one stream (zlib and zstd release the
# GIL; every frame is independent, so the output is the same bytes)
_COMPRESS_WORKERS = min(8, os.cpu_count() or 1)


# ---------------------------------------------------------------------------
# codec registry
# ---------------------------------------------------------------------------

@runtime_checkable
class Codec(Protocol):
    """One compression algorithm: ``codec_id`` is the on-disk number,
    ``name`` the handle callers use."""

    name: str
    codec_id: int

    def compress(self, data: bytes, level: Optional[int]) -> bytes: ...

    def decompress(self, data: bytes, raw_len: int) -> bytes: ...


class ZlibCodec:
    """Stdlib zlib (DEFLATE), always available."""

    name = "zlib"
    codec_id = 1

    def compress(self, data: bytes, level: Optional[int] = None) -> bytes:
        return zlib.compress(data, -1 if level is None else level)

    def decompress(self, data: bytes, raw_len: int) -> bytes:
        try:
            return zlib.decompress(data, bufsize=max(raw_len, 64))
        except zlib.error as exc:
            raise ValueError(f"zlib frame decompression failed: {exc}") from None


class ZstdCodec:
    """The ``zstandard`` package; registered only when it imports."""

    name = "zstd"
    codec_id = 2

    def __init__(self):
        import zstandard
        self._mod = zstandard

    def compress(self, data: bytes, level: Optional[int] = None) -> bytes:
        cctx = self._mod.ZstdCompressor(level=3 if level is None else level)
        return cctx.compress(data)

    def decompress(self, data: bytes, raw_len: int) -> bytes:
        try:
            return self._mod.ZstdDecompressor().decompress(
                data, max_output_size=max(raw_len, 64))
        except self._mod.ZstdError as exc:
            raise ValueError(f"zstd frame decompression failed: {exc}") from None


_CODECS: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    """Register under ``codec.name`` (last wins).  ``codec_id`` must be
    unique and nonzero (0 is the reserved "stored" id)."""
    if codec.codec_id == CODEC_RAW:
        raise ValueError("codec_id 0 is reserved for uncompressed data")
    for other in _CODECS.values():
        if other.codec_id == codec.codec_id and other.name != codec.name:
            raise ValueError(
                f"codec_id {codec.codec_id} already taken by {other.name!r}")
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; available: {available_codecs()}"
        ) from None


def codec_for_id(codec_id: int) -> Codec:
    for codec in _CODECS.values():
        if codec.codec_id == codec_id:
            return codec
    hint = " (is the zstandard package installed?)" if codec_id == 2 else ""
    raise ValueError(f"unknown codec id {codec_id}{hint}; "
                     f"available: {available_codecs()}")


def available_codecs() -> list:
    return sorted(_CODECS)


def parse_codec_spec(spec: str) -> Tuple[Codec, Optional[int]]:
    """``"zlib"`` / ``"zstd:9"`` -> (codec, level-or-None)."""
    name, _, level = spec.partition(":")
    codec = get_codec(name)
    if not level:
        return codec, None
    try:
        return codec, int(level)
    except ValueError:
        raise ValueError(f"bad codec level {level!r} in spec {spec!r}") from None


register_codec(ZlibCodec())
try:                               # zstd is optional
    register_codec(ZstdCodec())
except ImportError:
    pass


# ---------------------------------------------------------------------------
# frame layer (shared by framed files and .gvel v2 sections)
# ---------------------------------------------------------------------------

def frame_count_for(raw_len: int, frame_beta: int) -> int:
    """Frames in a stream over ``raw_len`` bytes (>= 1: empty input is one
    empty frame, so every stream has a checksummed frame)."""
    return max(1, -(-raw_len // frame_beta))


def compress_frames(data, codec: Codec, *, level: Optional[int] = None,
                    frame_beta: int = DEFAULT_FRAME_BETA) -> bytes:
    """Bytes -> concatenated ``[header | payload]`` frames, one frame per
    ``frame_beta``-sized block of the input (the last may be short).  The
    frames are compressed by a few threads; the bytes are the same as one
    thread's."""
    if frame_beta <= 0:
        raise ValueError(f"frame_beta must be positive, got {frame_beta}")
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = memoryview(data).cast("B")
    else:
        buf = memoryview(np.ascontiguousarray(np.asarray(data, np.uint8)))
    blocks = [buf[lo:lo + frame_beta]
              for lo in range(0, len(buf), frame_beta)] or [buf[0:0]]

    def frame(raw) -> bytes:
        comp = codec.compress(raw, level)
        return struct.pack(FRAME_HDR_FMT, len(comp), len(raw),
                           zlib.crc32(raw)) + comp
    if len(blocks) == 1 or _COMPRESS_WORKERS == 1:
        return b"".join(map(frame, blocks))
    with ThreadPoolExecutor(_COMPRESS_WORKERS) as pool:
        return b"".join(pool.map(frame, blocks))


def iter_decompressed_frames(payload, codec: Codec, *,
                             context: str = "frame stream",
                             start_frame: int = 0,
                             stop_frame: Optional[int] = None,
                             ) -> Iterator[bytes]:
    """Yield validated uncompressed frame payloads in order.

    Frames before ``start_frame`` are walked (headers validated, payloads
    never decompressed) and iteration stops before ``stop_frame``.  Raises
    ``ValueError`` on a truncated frame header or payload, a declared-length
    mismatch after decompression, or a CRC32 mismatch.
    """
    view = memoryview(payload)
    pos = 0
    idx = 0
    while pos < len(view):
        if stop_frame is not None and idx >= stop_frame:
            return
        if pos + FRAME_HDR_LEN > len(view):
            raise ValueError(
                f"{context}: truncated frame header for frame {idx} at "
                f"byte {pos} ({len(view) - pos} of {FRAME_HDR_LEN} bytes)")
        comp_len, raw_len, crc = struct.unpack_from(FRAME_HDR_FMT, view, pos)
        payload_pos = pos + FRAME_HDR_LEN
        pos = payload_pos
        if pos + comp_len > len(view):
            raise ValueError(
                f"{context}: truncated frame payload for frame {idx} at "
                f"byte {pos} ({len(view) - pos} of {comp_len} declared "
                f"bytes)")
        if idx < start_frame:         # seek: skip the compressed payload
            pos += comp_len
            idx += 1
            continue
        comp = bytes(view[pos:pos + comp_len])
        if _faults._ACTIVE is not None:
            for f in _faults.inject("frame", idx, where=context):
                comp = _faults.corrupt_bytes(comp, f, salt=idx)
        try:
            raw = codec.decompress(comp, raw_len)
        except ValueError as exc:
            raise ValueError(
                f"{context}: frame {idx} at byte {payload_pos}: "
                f"{exc}") from None
        pos += comp_len
        idx += 1
        if len(raw) != raw_len:
            raise ValueError(
                f"{context}: frame {idx - 1} at byte {payload_pos} declared "
                f"{raw_len} uncompressed bytes but decompressed to "
                f"{len(raw)}")
        if zlib.crc32(raw) != crc:
            raise ValueError(
                f"{context}: frame {idx - 1} checksum mismatch at byte "
                f"{payload_pos} (corrupt payload)")
        yield raw


@dataclasses.dataclass(frozen=True)
class FrameEntry:
    """One frame's coordinates in a frame stream: its compressed payload
    (``payload_off``/``comp_len``) and the uncompressed byte range it
    covers (``raw_off``/``raw_len``)."""

    index: int
    payload_off: int              # byte offset of compressed payload
    comp_len: int
    raw_off: int                  # cumulative uncompressed offset
    raw_len: int
    crc: int

    @property
    def raw_end(self) -> int:
        return self.raw_off + self.raw_len


def frame_table(payload, *, context: str = "frame stream") -> list:
    """Walk a frame stream's 12-byte headers into a seek index (a list of
    :class:`FrameEntry`) without decompressing anything.  Raises
    ``ValueError`` on a truncated header or a payload running past the end
    of the stream."""
    view = memoryview(payload)
    entries = []
    pos = 0
    raw_off = 0
    idx = 0
    while pos < len(view):
        if pos + FRAME_HDR_LEN > len(view):
            raise ValueError(
                f"{context}: truncated frame header for frame {idx} at "
                f"byte {pos} ({len(view) - pos} of {FRAME_HDR_LEN} bytes)")
        comp_len, raw_len, crc = struct.unpack_from(FRAME_HDR_FMT, view, pos)
        pos += FRAME_HDR_LEN
        if pos + comp_len > len(view):
            raise ValueError(
                f"{context}: truncated frame payload for frame {idx} at "
                f"byte {pos} ({len(view) - pos} of {comp_len} declared "
                f"bytes)")
        entries.append(FrameEntry(idx, pos, comp_len, raw_off, raw_len, crc))
        pos += comp_len
        raw_off += raw_len
        idx += 1
    return entries


def count_frames(payload, *, context: str = "frame stream") -> int:
    """Frame count of a stream by header walk (no decompression)."""
    return len(frame_table(payload, context=context))


def frames_overlapping(entries: list, byte_lo: int, byte_hi: int) -> list:
    """The entries whose uncompressed byte ranges overlap ``[byte_lo,
    byte_hi)``: the frames a partial read must decode, and no others."""
    if byte_hi <= byte_lo:
        return []
    return [e for e in entries
            if e.raw_off < byte_hi and e.raw_end > byte_lo and e.raw_len]


def decode_frame(payload, entry: FrameEntry, codec: Codec, *,
                 context: str = "frame stream") -> bytes:
    """Decompress and checksum exactly one frame of a stream (``entry``
    from :func:`frame_table`).  Raises ``ValueError`` on a declared-length
    or CRC32 mismatch."""
    view = memoryview(payload)
    comp = bytes(view[entry.payload_off:entry.payload_off + entry.comp_len])
    if _faults._ACTIVE is not None:
        for f in _faults.inject("frame", entry.index, where=context):
            comp = _faults.corrupt_bytes(comp, f, salt=entry.index)
    try:
        raw = codec.decompress(comp, entry.raw_len)
    except ValueError as exc:
        raise ValueError(
            f"{context}: frame {entry.index} at byte {entry.payload_off}: "
            f"{exc}") from None
    if len(raw) != entry.raw_len:
        raise ValueError(
            f"{context}: frame {entry.index} at byte {entry.payload_off} "
            f"declared {entry.raw_len} uncompressed bytes but decompressed "
            f"to {len(raw)}")
    if zlib.crc32(raw) != entry.crc:
        raise ValueError(
            f"{context}: frame {entry.index} checksum mismatch at byte "
            f"{entry.payload_off} (corrupt payload)")
    return raw


def decompress_frames(payload, raw_len: int, codec: Codec, *,
                      context: str = "frame stream") -> np.ndarray:
    """Whole frame stream -> uint8 array of exactly ``raw_len`` bytes."""
    out = np.empty(raw_len, np.uint8)
    pos = 0
    for idx, raw in enumerate(
            iter_decompressed_frames(payload, codec, context=context)):
        if pos + len(raw) > raw_len:
            raise ValueError(
                f"{context}: frame {idx} decompresses past the declared "
                f"total ({pos + len(raw)} > {raw_len} bytes)")
        out[pos:pos + len(raw)] = np.frombuffer(raw, np.uint8)
        pos += len(raw)
    if pos != raw_len:
        raise ValueError(f"{context}: frames decompress to {pos} bytes, "
                         f"expected {raw_len}")
    return out


# ---------------------------------------------------------------------------
# framed file container
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FramedInfo:
    """Validated header of a framed compressed file."""

    path: str
    codec: Codec
    frame_beta: int
    orig_len: int
    frame_count: int
    payload_offset: int


def write_framed(out_path: str, data, *, codec: str = "zlib",
                 level: Optional[int] = None,
                 frame_beta: int = DEFAULT_FRAME_BETA) -> None:
    """Compress ``data`` (bytes / uint8 array) into a framed container."""
    c = get_codec(codec)
    n = len(data) if isinstance(data, (bytes, bytearray)) else \
        int(np.asarray(data).size)
    payload = compress_frames(data, c, level=level, frame_beta=frame_beta)
    with open(out_path, "wb") as f:
        f.write(struct.pack(FRAMED_HDR_FMT, FRAMED_MAGIC, FRAMED_VERSION,
                            c.codec_id, frame_beta, n,
                            frame_count_for(n, frame_beta), 0))
        f.write(payload)


def compress_file_framed(in_path: str, out_path: str, *, codec: str = "zlib",
                         level: Optional[int] = None,
                         frame_beta: int = DEFAULT_FRAME_BETA) -> None:
    write_framed(out_path, mmap_bytes(in_path), codec=codec, level=level,
                 frame_beta=frame_beta)


def _starts_with(path: str, magic: bytes) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(magic)) == magic
    except OSError:
        return False


def is_framed(path: str) -> bool:
    return _starts_with(path, FRAMED_MAGIC)


def is_gzip(path: str) -> bool:
    return _starts_with(path, GZIP_MAGIC)


def compression_of(path: str) -> Optional[str]:
    """``"framed"`` / ``"gzip"`` / None, by magic sniff (never extension)."""
    if is_framed(path):
        return "framed"
    if is_gzip(path):
        return "gzip"
    return None


def read_framed_header(path: str) -> FramedInfo:
    size = os.path.getsize(path)
    if size < FRAMED_HDR_LEN:
        raise ValueError(f"{path}: truncated framed header ({size} bytes)")
    with open(path, "rb") as f:
        hdr = f.read(FRAMED_HDR_LEN)
    magic, version, codec_id, frame_beta, orig_len, count, reserved = \
        struct.unpack(FRAMED_HDR_FMT, hdr)
    if magic != FRAMED_MAGIC:
        raise ValueError(f"{path}: bad magic {magic!r}, not a framed file")
    if version != FRAMED_VERSION:
        raise ValueError(f"{path}: unsupported framed version {version} "
                         f"(this reader supports {FRAMED_VERSION})")
    if reserved != 0:
        raise ValueError(f"{path}: nonzero reserved framed header field")
    if frame_beta <= 0:
        raise ValueError(f"{path}: framed header has frame_beta {frame_beta}")
    try:
        codec = codec_for_id(codec_id)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    if count != frame_count_for(orig_len, frame_beta):
        raise ValueError(
            f"{path}: header declares {count} frames, but {orig_len} bytes "
            f"at frame_beta {frame_beta} is "
            f"{frame_count_for(orig_len, frame_beta)}")
    return FramedInfo(path, codec, frame_beta, orig_len, count,
                      FRAMED_HDR_LEN)


def _framed_chunks(info: FramedInfo, start_frame: int = 0,
                   stop_frame: Optional[int] = None) -> Iterator[bytes]:
    """Sequential frame payloads of a framed file: each ``next()``
    decompresses exactly one frame (the prefetch thread's fuel)."""
    data = mmap_bytes(info.path, info.payload_offset)
    yield from iter_decompressed_frames(data, info.codec, context=info.path,
                                        start_frame=start_frame,
                                        stop_frame=stop_frame)


def _gzip_chunks(path: str) -> Iterator[bytes]:
    """Sequential ``_GZ_CHUNK``-sized chunks of a gzip file."""
    try:
        with gzip.open(path, "rb") as f:
            while True:
                chunk = f.read(_GZ_CHUNK)
                if not chunk:
                    return
                yield chunk
    except (EOFError, zlib.error, gzip.BadGzipFile) as exc:
        raise ValueError(f"{path}: corrupt gzip stream: {exc}") from None


def gzip_length_hint(path: str) -> int:
    """Uncompressed length from the gzip trailer (ISIZE): exact for
    single-member files under 4 GiB; a wrong hint is caught by the
    source's ``finish``."""
    size = os.path.getsize(path)
    if size < 18:                  # header (10) + trailer (8)
        raise ValueError(f"{path}: truncated gzip file ({size} bytes)")
    with open(path, "rb") as f:
        f.seek(-4, os.SEEK_END)
        return struct.unpack("<I", f.read(4))[0]


# ---------------------------------------------------------------------------
# loader integration: whole-file bytes, streams, block sources
# ---------------------------------------------------------------------------

def file_bytes(path: str, offset: int = 0) -> np.ndarray:
    """Uncompressed file bytes as uint8, ``offset`` applied after
    decompression.  Raw files stay a zero-copy mmap; compressed files are
    decompressed in memory."""
    kind = compression_of(path)
    if kind is None:
        return mmap_bytes(path, offset)
    if kind == "gzip":
        data = np.frombuffer(b"".join(_gzip_chunks(path)), np.uint8)
    else:
        info = read_framed_header(path)
        data = decompress_frames(mmap_bytes(path, info.payload_offset),
                                 info.orig_len, info.codec, context=path)
    return data[offset:] if offset else data


class _FramedRawIO(io.RawIOBase):
    """Forward-only raw IO over a framed file's uncompressed bytes; ``tell``
    reports uncompressed positions (wrap in ``io.BufferedReader`` for
    ``readline``)."""

    def __init__(self, info: FramedInfo):
        self._chunks = _framed_chunks(info)
        self._pending = b""
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True                   # for BufferedReader.tell() only

    def tell(self) -> int:
        return self._pos

    def seek(self, pos, whence=os.SEEK_SET):
        if (whence == os.SEEK_SET and pos == self._pos) or \
                (whence == os.SEEK_CUR and pos == 0):
            return self._pos          # no-op seeks keep tell() working
        raise io.UnsupportedOperation(
            "framed streams are forward-only; seek is not supported")

    def readinto(self, b) -> int:
        while not self._pending:
            chunk = next(self._chunks, None)
            if chunk is None:
                return 0
            self._pending = chunk
        n = min(len(b), len(self._pending))
        b[:n] = self._pending[:n]
        self._pending = self._pending[n:]
        self._pos += n
        return n


def open_stream(path: str):
    """Binary file-like over the uncompressed bytes of ``path``; ``tell()``
    reports uncompressed positions, so an MTX body offset means the same
    thing for every input."""
    kind = compression_of(path)
    if kind is None:
        return open(path, "rb")
    if kind == "gzip":
        return gzip.open(path, "rb")
    return io.BufferedReader(_FramedRawIO(read_framed_header(path)))


def peek_bytes(path: str, n: int) -> bytes:
    """First ``n`` uncompressed bytes (b"" on unreadable or corrupt files:
    a sniffing helper, not a validator)."""
    try:
        with open_stream(path) as f:
            return f.read(n)
    except (OSError, ValueError, EOFError, zlib.error):
        return b""


_GZIP_HINT = (" (multi-member or >4 GiB gzip? the trailer length is "
              "unreliable there -- recompress with "
              "repro_torch.core.codecs.compress_file_framed)")


def open_block_source(path: str, offset: int = 0):
    """The streaming loader's input factory: ``(block source,
    forced_beta-or-None)``.  Raw files get a random-access source over the
    mmap; gzip and framed files a sequential source whose chunks are
    decompressed as the loader's prefetch thread pulls them.  Framed files
    force the plan's block size to ``frame_beta``."""
    kind = compression_of(path)
    if kind is None:
        source = MemoryBlockSource(mmap_bytes(path, offset))
        return _faults.wrap_block_source(source, path), None
    if kind == "gzip":
        length = gzip_length_hint(path)
        source = SequentialBlockSource(
            _gzip_chunks(path), length - offset, skip=offset,
            describe=f"{path} (gzip)", mismatch_hint=_GZIP_HINT)
        return _faults.wrap_block_source(source, f"{path} (gzip)"), None
    info = read_framed_header(path)
    where = f"{path} (framed {info.codec.name})"
    source = SequentialBlockSource(
        _framed_chunks(info), info.orig_len - offset, skip=offset,
        describe=where)
    return _faults.wrap_block_source(source, where), info.frame_beta


def stream_geometry(path: str, offset: int = 0) -> Tuple[int, Optional[int]]:
    """``(uncompressed post-offset length, forced_beta-or-None)`` without
    opening a block source."""
    kind = compression_of(path)
    if kind is None:
        return max(os.path.getsize(path) - offset, 0), None
    if kind == "gzip":
        return max(gzip_length_hint(path) - offset, 0), None
    info = read_framed_header(path)
    return max(info.orig_len - offset, 0), info.frame_beta


def open_shard_block_source(path: str, plan, span, offset: int = 0):
    """A block source that stages exactly ``span``'s blocks of ``plan``
    (the plan of :func:`stream_geometry`'s length and forced beta; ``span``
    a :class:`~.blocks.ShardSpan` with at least one block).  Per codec:

    * raw: a :class:`MemoryBlockSource` over the shared mmap;
    * framed: the frame headers are a seek index, so the chunks start at the
      frame holding the span's leftmost needed byte (its first owned byte
      less ``overlap``) and stop after its last frame; earlier frames are
      walked by header, never inflated;
    * gzip: DEFLATE has no seek index, so the shard inflates and drops the
      prefix before its span (a cost that grows with the shard index).
    """
    if span.num_blocks <= 0:
        raise ValueError(
            f"shard {span.shard}/{span.num_shards} owns no blocks; "
            f"callers skip opening sources for empty spans")
    kind = compression_of(path)
    tag = f"shard {span.shard}/{span.num_shards}"
    if kind is None:
        source = MemoryBlockSource(mmap_bytes(path, offset))
        return _faults.wrap_block_source(source, f"{path} ({tag})")
    if kind == "gzip":
        start = max(span.block_lo * plan.beta - plan.overlap, 0)
        end = plan.file_len if span.block_hi >= plan.num_blocks \
            else min(span.block_hi * plan.beta, plan.file_len)
        where = f"{path} (gzip, {tag})"
        source = SequentialBlockSource(
            _gzip_chunks(path), plan.file_len, skip=offset + start,
            start=start, end=end, first_block=span.block_lo,
            describe=where, mismatch_hint=_GZIP_HINT)
        return _faults.wrap_block_source(source, where)
    info = read_framed_header(path)
    fb = info.frame_beta
    # pre-offset byte range the span needs: its blocks and left context
    start_pre = max(span.block_lo * plan.beta - plan.overlap, 0) + offset
    end_pre = min(span.block_hi * plan.beta + offset, info.orig_len)
    frame_lo = min(start_pre // fb, max(info.frame_count - 1, 0))
    frame_hi = max(min(-(-end_pre // fb), info.frame_count), frame_lo)
    start = max(frame_lo * fb - offset, 0)
    where = f"{path} (framed {info.codec.name}, {tag})"
    source = SequentialBlockSource(
        _framed_chunks(info, frame_lo, frame_hi), plan.file_len,
        skip=max(offset - frame_lo * fb, 0), start=start,
        end=max(end_pre - offset, start), first_block=span.block_lo,
        describe=where)
    return _faults.wrap_block_source(source, where)
