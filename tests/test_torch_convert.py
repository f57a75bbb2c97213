"""``python -m repro_torch.scripts.convert`` held against the JAX package's
``scripts/convert.py`` (``tests/test_convert.py``) on the CPU.

The same inputs (text and MTX, raw and zlib, weighted and not) go through
both CLIs, the reference's with ``--engine device``; the ``.gvel`` files
they write must be byte-identical and equal the numpy oracle, and the
error paths must give the same exit codes (0, 1, 2) and messages.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core import open_graph, write_edgelist
from repro_torch.core.build import csr_np
from repro_torch.core.mtx import write_mtx
from repro_torch.scripts import convert

import torch_serving as ts

_REF = os.path.join(os.path.dirname(__file__), "..", "scripts", "convert.py")
_spec = importlib.util.spec_from_file_location("convert_cli_ref", _REF)
ref_cli = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_cli)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _inputs(tmp_path, informat, weighted, seed=0, v=40, e=200):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e)
    dst = rng.integers(0, v, e)
    w = ((rng.random(e) * 9).round(3).astype(np.float32) if weighted
         else None)
    if informat == "text":
        path = str(tmp_path / "g.el")
        write_edgelist(path, src, dst, w, base=1)
    else:
        path = str(tmp_path / "g.mtx")
        write_mtx(path, src, dst, w, num_vertices=v)
    oracle = csr_np(src.astype(np.int32), dst.astype(np.int32), w, v)
    return path, v, e, oracle


def _run_both(tmp_path, args, capsys):
    """Each CLI writes ``port.gvel`` / ``ref.gvel``; returns the exit codes,
    the stderr of each, and the two output paths."""
    out = []
    for name, main, extra in (("port", convert.main, ["--device", "cpu"]),
                              ("ref", ref_cli.main, ["--engine", "device"])):
        path = str(tmp_path / f"{name}.gvel")
        rc = main([a.replace("OUT", path) for a in args] + extra)
        out.append((rc, capsys.readouterr().err, path))
    return out


@pytest.mark.parametrize("informat", ["text", "mtx"])
@pytest.mark.parametrize("compress", [None, "zlib"])
@pytest.mark.parametrize("weighted", [False, True])
def test_convert_matrix_writes_the_reference_bytes(tmp_path, capsys,
                                                   informat, compress,
                                                   weighted):
    path, v, e, oracle = _inputs(tmp_path, informat, weighted,
                                 seed=2 * weighted + (compress is not None))
    args = [path, "OUT"]
    if informat == "text":
        args += ["--num-vertices", str(v)]
        if weighted:
            args.append("--weighted")
    if compress:
        args += ["--compress", compress]
    (rc, _, port), (jrc, _, ref) = _run_both(tmp_path, args, capsys)
    assert rc == jrc == 0
    assert open(port, "rb").read() == open(ref, "rb").read()
    info = open_graph(port, device="cpu").info()
    assert (info.format, info.version, info.codec) == (
        "gvel", 2 if compress else 1, compress)
    assert (info.num_vertices, info.num_edges, info.weighted) == (
        v, e, weighted)
    assert info.has_edgelist and info.has_csr
    csr = open_graph(port, device="cpu").csr()
    assert ts.same(csr.offsets, oracle.offsets)
    assert ts.same(csr.targets, oracle.targets)
    if informat == "text":
        # write_mtx prints float32 weights with 16 digits, past what the
        # parse's int32 mantissa holds, in both packages alike
        assert ts.same(csr.weights, oracle.weights)


def test_convert_mtx_warns_about_ignored_text_flags(tmp_path, capsys):
    path, v, e, _ = _inputs(tmp_path, "mtx", weighted=False)
    (rc, err, _), (jrc, jerr, _) = _run_both(
        tmp_path, [path, "OUT", "--weighted", "--base", "0"], capsys)
    assert rc == jrc == 0
    assert "--weighted" in err and "--base" in err and "ignored" in err
    assert err.split(" ignored")[0] == jerr.split(" ignored")[0]


def test_convert_no_csr_and_level_spec(tmp_path, capsys):
    path, v, e, _ = _inputs(tmp_path, "text", weighted=False)
    (rc, _, port), (jrc, _, ref) = _run_both(
        tmp_path, [path, "OUT", "--num-vertices", str(v), "--no-csr",
                   "--compress", "zlib:9"], capsys)
    assert rc == jrc == 0
    assert open(port, "rb").read() == open(ref, "rb").read()
    info = open_graph(port, device="cpu").info()
    assert info.has_edgelist and not info.has_csr
    assert info.codec == "zlib" and info.version == 2


def test_convert_unreadable_input(tmp_path, capsys):
    (rc, err, port), (jrc, jerr, _) = _run_both(
        tmp_path, [str(tmp_path / "missing.el"), "OUT"], capsys)
    assert rc == jrc == 1
    assert err == jerr.replace("ref.gvel", "port.gvel")
    assert not os.path.exists(port)


def test_convert_refuses_overwrite_without_force(tmp_path, capsys):
    path, v, e, _ = _inputs(tmp_path, "text", weighted=False)
    out = str(tmp_path / "g.gvel")
    base = [path, out, "--num-vertices", str(v), "--device", "cpu"]
    assert convert.main(base) == 0
    before = open(out, "rb").read()
    assert convert.main(base) == 2
    assert "refusing to overwrite" in capsys.readouterr().err
    assert open(out, "rb").read() == before
    assert convert.main(base + ["--force", "--compress", "zlib"]) == 0
    assert open_graph(out, device="cpu").info().version == 2


def test_convert_unknown_engine_lists_available(tmp_path, capsys):
    path, v, e, _ = _inputs(tmp_path, "text", weighted=False)
    rc = convert.main([path, str(tmp_path / "o.gvel"), "--engine",
                       "no-such-engine", "--device", "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "unknown loader engine" in err and "'device'" in err


def test_convert_bad_codec_spec(tmp_path, capsys):
    path, v, e, _ = _inputs(tmp_path, "text", weighted=False)
    (rc, err, _), (jrc, jerr, _) = _run_both(
        tmp_path, [path, "OUT", "--compress", "zlib:notanint"], capsys)
    assert rc == jrc == 1
    assert "codec level" in err and err == jerr


def test_convert_without_a_card_fails_with_exit_1(tmp_path):
    """The default device is CUDA: without one, exit 1 and say so."""
    path, v, e, _ = _inputs(tmp_path, "text", weighted=False)
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from repro_torch.scripts.convert import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    out = subprocess.run(
        [sys.executable, "-c", code, path, str(tmp_path / "o.gvel")],
        env=dict(os.environ, PYTHONPATH=os.path.abspath(SRC)),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr
    assert not os.path.exists(str(tmp_path / "o.gvel"))
