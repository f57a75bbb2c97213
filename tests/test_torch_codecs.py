"""The port's codecs and framed containers held against ``repro.core.codecs``
on the CPU.

Framed files written by either package are read by the other and are
byte-identical for the same input, codec, level and frame size; a framed
text file loads through the port's streaming loader to the JAX package's
CSR bitwise (tolerance 0: integers and float32 bit patterns).  Inputs are
made from a seed with numpy.
"""
import os

import numpy as np
import pytest
import torch

import repro.core.codecs as jcodecs
from repro.core import load_csr as jax_load_csr
from repro.core.source import open_graph as jax_open
import repro_torch
from repro_torch.core import codecs
from repro_torch.core.build import csr_np

import torch_inputs as ti

CODECS = ["zlib", "zstd"]


def _oracle(src, dst, w, v):
    """(offsets, targets, weights) of the port's host oracle."""
    o = csr_np(src, dst, w, v)
    return o.offsets, o.targets, o.weights


def _bytes(seed, n):
    """Compressible bytes: text-like digits with some runs."""
    rng = np.random.default_rng(seed)
    return bytes(rng.choice(np.frombuffer(b"0123456789 \n", np.uint8), n)
                 .astype(np.uint8))


def test_codec_registry_matches_reference():
    assert codecs.available_codecs() == jcodecs.available_codecs()
    for name in codecs.available_codecs():
        assert codecs.get_codec(name).codec_id == \
            jcodecs.get_codec(name).codec_id
        assert codecs.codec_for_id(codecs.get_codec(name).codec_id).name \
            == name
    codec, level = codecs.parse_codec_spec("zlib:6")
    assert (codec.name, level) == ("zlib", 6)
    with pytest.raises(ValueError, match="unknown codec"):
        codecs.get_codec("lz4")
    with pytest.raises(ValueError, match="reserved"):
        codecs.register_codec(type("C", (), {"name": "x", "codec_id": 0})())


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n,frame_beta,level", [
    (0, 64, None), (1, 64, 1), (4095, 1024, None), (10000, 96, 9),
    (70000, codecs.DEFAULT_FRAME_BETA, 1)])
def test_framed_files_are_byte_identical_and_cross_read(
        tmp_path, codec, n, frame_beta, level):
    data = _bytes(n, n)
    ours, theirs = str(tmp_path / "ours.elz"), str(tmp_path / "theirs.elz")
    codecs.write_framed(ours, data, codec=codec, level=level,
                        frame_beta=frame_beta)
    jcodecs.write_framed(theirs, data, codec=codec, level=level,
                         frame_beta=frame_beta)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        assert codecs.file_bytes(path).tobytes() == data
        assert jcodecs.file_bytes(path).tobytes() == data
        assert codecs.file_bytes(path, 3).tobytes() == data[3:]
        info = codecs.read_framed_header(path)
        assert (info.frame_beta, info.orig_len, info.frame_count) == \
            (frame_beta, n, codecs.frame_count_for(n, frame_beta))
        assert codecs.compression_of(path) == "framed"
        with codecs.open_stream(path) as f:
            assert f.read() == data
    # the frame layer alone, and its seek index
    payload = codecs.compress_frames(data, codecs.get_codec(codec),
                                     level=level, frame_beta=frame_beta)
    assert payload == jcodecs.compress_frames(
        data, jcodecs.get_codec(codec), level=level, frame_beta=frame_beta)
    table = codecs.frame_table(payload)
    assert [tuple(vars(e).values()) for e in table] == \
        [tuple(vars(e).values()) for e in jcodecs.frame_table(payload)]
    parts = [codecs.decode_frame(payload, e, codecs.get_codec(codec))
             for e in table]
    assert b"".join(parts) == data
    lo, hi = n // 3, n // 3 + 5
    assert [e.index for e in codecs.frames_overlapping(table, lo, hi)] == \
        [e.index for e in jcodecs.frames_overlapping(
            jcodecs.frame_table(payload), lo, hi)]


@pytest.mark.parametrize("damage", ["flip", "crc", "truncate"])
def test_damaged_frames_raise_in_both(damage):
    data = _bytes(3, 5000)
    codec = codecs.get_codec("zlib")
    payload = bytearray(codecs.compress_frames(data, codec, frame_beta=1024))
    entry = codecs.frame_table(bytes(payload))[2]
    if damage == "flip":
        payload[entry.payload_off + entry.comp_len // 2] ^= 0x40
    elif damage == "crc":
        payload[entry.payload_off - 1] ^= 0x01     # last byte of its crc
    else:
        payload = payload[:entry.payload_off + 3]
    payload = bytes(payload)
    for mod in (codecs, jcodecs):
        with pytest.raises(ValueError):
            mod.decompress_frames(payload, len(data), mod.get_codec("zlib"))
    if damage != "truncate":
        entry = codecs.frame_table(payload)[2]
        with pytest.raises(ValueError, match="frame 2"):
            codecs.decode_frame(payload, entry, codec)
    else:
        with pytest.raises(ValueError, match="truncated"):
            codecs.frame_table(payload)


def test_open_stream_and_peek_report_uncompressed_positions(tmp_path):
    data = b"%%MatrixMarket x\n% c\n3 3 2\n1 2\n2 3\n"
    path = str(tmp_path / "m.elz")
    codecs.write_framed(path, data, frame_beta=8)
    with codecs.open_stream(path) as f:
        f.readline()
        assert f.tell() == data.index(b"\n") + 1
    assert codecs.peek_bytes(path, 14) == data[:14]
    assert codecs.peek_bytes(str(tmp_path / "missing"), 4) == b""
    assert codecs.stream_geometry(path, 5) == (len(data) - 5, 8)
    assert codecs.stream_geometry(path) == jcodecs.stream_geometry(path)


def test_open_block_source_forces_the_frame_size(tmp_path):
    data = _bytes(5, 9000)
    raw = str(tmp_path / "g.el")
    open(raw, "wb").write(data)
    framed = str(tmp_path / "g.elz")
    codecs.write_framed(framed, data, frame_beta=2048)
    src, beta = codecs.open_block_source(raw)
    assert beta is None and src.length == len(data)
    src, beta = codecs.open_block_source(framed, offset=10)
    assert beta == 2048 and src.length == len(data) - 10


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("method", ["staged", "global", "binned"])
def test_framed_text_loads_like_the_reference(tmp_path, codec, weighted,
                                              method):
    src, dst, w = ti.graph_edges(11, v=90, e=3000, weighted=weighted)
    text = str(tmp_path / "g.el")
    ti.write_text(text, src, dst, w)
    framed = str(tmp_path / "g.elz")
    codecs.compress_file_framed(text, framed, codec=codec, frame_beta=4096)
    got = repro_torch.open_graph(framed, device="cpu", weighted=weighted)
    csr = got.csr(method=method)
    want = jax_load_csr(framed, engine="device", weighted=weighted,
                        method=method)
    assert csr.offsets.dtype == torch.int64
    assert np.array_equal(csr.offsets.numpy(), np.asarray(want.offsets))
    assert np.array_equal(csr.targets.numpy(), np.asarray(want.targets))
    off, tgt, ww = _oracle(src, dst, w, 87)
    assert np.array_equal(csr.targets.numpy(), tgt)
    if weighted:
        assert np.array_equal(csr.weights.numpy().view(np.int32),
                              np.asarray(want.weights).view(np.int32))
        assert np.array_equal(csr.weights.numpy().view(np.int32),
                              ww.view(np.int32))
    el = got.edgelist()
    assert np.array_equal(el.src.numpy(), src)
    assert np.array_equal(el.dst.numpy(), dst)


def test_framed_info_matches_reference(tmp_path):
    text = str(tmp_path / "g.el")
    ti.write_text(text, *ti.graph_edges(2)[:2])
    framed = str(tmp_path / "g.elz")
    codecs.compress_file_framed(text, framed, codec="zstd", level=3,
                                frame_beta=512)
    got = repro_torch.open_graph(framed, device="cpu").info().to_dict()
    want = jax_open(framed).info().to_dict()
    assert got.pop("device") == "cpu"
    assert got == want
    assert got["codec"] == "framed-zstd"
    assert got["raw_bytes"] == os.path.getsize(text)


def test_framed_short_stream_is_refused(tmp_path):
    """A framed container whose frames hold fewer bytes than its header
    declares fails the load instead of returning a partial graph."""
    text = b"1 2\n3 4\n" * 300
    path = str(tmp_path / "g.elz")
    codecs.write_framed(path, text, frame_beta=512)
    blob = bytearray(open(path, "rb").read())
    # declare one frame fewer over a shorter original: the header check
    # holds, the stream then ends early
    import struct
    hdr = list(struct.unpack(codecs.FRAMED_HDR_FMT,
                             bytes(blob[:codecs.FRAMED_HDR_LEN])))
    hdr[4] += 512                  # orig_len
    hdr[5] += 1                    # frame_count
    blob[:codecs.FRAMED_HDR_LEN] = struct.pack(codecs.FRAMED_HDR_FMT, *hdr)
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="expected"):
        repro_torch.open_graph(path, device="cpu").csr()
