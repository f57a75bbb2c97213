"""Compressed inputs for the streaming loader: the subset the port needs.

The port's own copy of part of ``repro/core/codecs.py``: gzip and framed
magic sniffing, gzip streaming, and :func:`open_block_source` for raw and
gzip text.  Framed-zlib/zstd containers are recognised and refused until
ROADMAP Queue 1 item 6 ports them.
"""
from __future__ import annotations

import gzip
import os
import struct
import zlib
from typing import Iterator, Optional

from .blocks import MemoryBlockSource, SequentialBlockSource, mmap_bytes

FRAMED_MAGIC = b"GVELFRMD"
GZIP_MAGIC = b"\x1f\x8b"

# decompression chunk pulled per prefetch-thread step for gzip streams
_GZ_CHUNK = 256 * 1024

FRAMED_NOT_PORTED = ("framed (zlib/zstd) containers are not ported yet: "
                     "ROADMAP Queue 1 item 6 (framed codecs, .gvel "
                     "snapshots, the front door's remaining products)")


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


def open_block_source(path: str, offset: int = 0):
    """The streaming loader's input factory: a random-access source over
    the mmap for raw files, a sequential decompressing source for gzip
    (decompression then runs in the loader's prefetch thread)."""
    kind = compression_of(path)
    if kind is None:
        return MemoryBlockSource(mmap_bytes(path, offset))
    if kind == "gzip":
        length = gzip_length_hint(path)
        return SequentialBlockSource(
            _gzip_chunks(path), length - offset, skip=offset,
            describe=f"{path} (gzip)",
            mismatch_hint=" (multi-member or >4 GiB gzip? the trailer "
                          "length is unreliable there)")
    raise NotImplementedError(f"{path}: {FRAMED_NOT_PORTED}")
