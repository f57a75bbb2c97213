"""The port's example twins (``repro_torch.examples``) and its copy of
``scripts/bench_diff.py`` on the CPU.

* ``quickstart`` at the reference's scale 14: its asserts hold, it prints
  the reference's lines, and the CSR it built equals the JAX package's
  numpy-engine CSR of the same file bitwise.
* ``distributed_load`` in a world of one (in this process) and in a gloo
  world of two (processes it spawns): the shards' edges sum to the
  graph's, rank 0 prints the reference's lines.
* ``serve_lm`` serves the reference's 12 requests; ``train_lm`` runs
  three steps of the reduced config on walks of a GVEL-loaded graph.
* ``repro_torch.scripts.bench_diff`` gives the reference's exit codes and
  messages on the same file pairs: no regression, a regression, a
  missing row, ``--require`` floors with and without ``--require-only``,
  a malformed file.
"""
import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.examples import (distributed_load, quickstart, serve_lm,
                                  train_lm)
from repro_torch.scripts import bench_diff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_at_the_reference_s_scale(tmp_path, capsys):
    """Its asserts hold and it prints the reference's lines; the snapshot
    it saved holds the JAX package's numpy-engine CSR, bitwise."""
    from repro.core import read_csr as jread_csr
    from repro_torch import open_graph
    assert quickstart.main(["--device", "cpu", "--workdir",
                            str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for line in ("generating an RMAT web-like graph ...",
                 "edgelist(): ", "csr() end-to-end (streaming device "
                 "engine): ", "degree stats: max=", "saved GraphSource(",
                 "csr() from .gvel snapshot", "compressed snapshot: ",
                 "csr() from compressed snapshot"):
        assert line in out, line
    assert "codec=zlib" in out
    v, e = (int(x.replace(",", "")) for x in re.search(
        r"\|V\|=([\d,]+) \|E\|=([\d,]+)", out).groups())
    assert v == 1 << 14 and e == 16 << 14
    want = jread_csr(str(tmp_path / "web.el"), num_vertices=v,
                     method="staged", engine="numpy")
    for name in ("web.gvel", "web.z.gvel"):
        csr = open_graph(str(tmp_path / name), device="cpu").csr().numpy()
        assert np.array_equal(csr.offsets, np.asarray(want.offsets)), name
        assert np.array_equal(csr.targets, np.asarray(want.targets)), name


def _reference_lines(out, world, e):
    assert f"devices: {world}" in out
    m = re.search(r"vertex-partitioned CSR: (\d+) shards x (\d+) rows; "
                  r"total edges=([\d,]+)", out)
    assert m and int(m.group(1)) == world
    assert int(m.group(3).replace(",", "")) == e
    assert out.strip().endswith("OK")
    shards = re.findall(r"shard (\d+): owns vertices \[(\d+), (\d+)\) with "
                        r"([\d,]+) edges", out)
    assert len(shards) == min(world, 4)
    rows = int(m.group(2))
    for k, lo, hi, _ in shards:
        assert (int(lo), int(hi)) == (int(k) * rows, (int(k) + 1) * rows)
    return sum(int(n.replace(",", "")) for *_, n in shards)


def test_distributed_load_in_a_world_of_one(capsys):
    got = distributed_load.rank_main("gloo", "cpu")
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    e = int(re.search(r"\|E\|=([\d,]+)", out).group(1).replace(",", ""))
    assert _reference_lines(out, 1, e) == e
    assert got["world"] == 1 and int(got["csr"].offsets[-1]) == e


def test_distributed_load_in_a_gloo_world_of_two(capfd):
    assert distributed_load.main(["--device", "cpu", "--world", "2"]) == 0
    out = capfd.readouterr().out
    e = int(re.search(r"\|E\|=([\d,]+)", out).group(1).replace(",", ""))
    assert _reference_lines(out, 2, e) == e


def test_serve_lm_serves_the_reference_s_requests(capsys):
    assert serve_lm.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"served (\d+) requests / (\d+) tokens", out)
    assert m and int(m.group(1)) == 12 and int(m.group(2)) == 12 * 24


def test_train_lm_trains_on_gvel_walks(capsys):
    assert train_lm.main(["--device", "cpu", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "GVEL: loaded |V|=" in out and "model: phi4-mini-3.8b (" in out
    first, last = (float(x) for x in re.search(
        r"loss: ([\d.]+) -> ([\d.]+)", out).groups())
    assert np.isfinite(first) and np.isfinite(last)
    assert "step     0 loss " in out


# ---- bench_diff -----------------------------------------------------------------

def _reference_bench_diff():
    spec = importlib.util.spec_from_file_location(
        "bench_diff_of_the_reference",
        os.path.join(ROOT, "scripts", "bench_diff.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
            err.write(str(e.code) if not isinstance(e.code, int) else "")
    return code, out.getvalue(), err.getvalue()


BASE = [{"name": "e2e.a", "speedup": 2.0}, {"name": "e2e.b", "speedup": 1.5},
        {"name": "fig.c", "speedup": 1.0}]
CASES = {
    "same": ([], BASE, 0),
    "regression": ([], [dict(BASE[0], speedup=1.0)] + BASE[1:], 1),
    "within_tol": (["--tol", "0.6"], [dict(BASE[0], speedup=1.0)] + BASE[1:],
                   0),
    "missing_row": ([], BASE[:2], 0),
    "rows_glob": (["--rows", "e2e.*"], [BASE[0], BASE[1]], 0),
    "require_ok": (["--require", "e2e.b>=1.2"], BASE, 0),
    "require_low": (["--require-only", "--require", "e2e.b>=1.8"], BASE, 1),
    "require_missing": (["--require-only", "--require", "e2e.z>=1.0"], BASE,
                        1),
    "bad_require": (["--require", "e2e.b"], BASE, 1),
    "malformed": ([], [{"name": "x"}], 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_diff_is_the_reference_s(tmp_path, case):
    flags, current, code = CASES[case]
    base, cur = tmp_path / "base.json", tmp_path / "cur.json"
    base.write_text(json.dumps(BASE))
    cur.write_text(json.dumps(current))
    argv = [str(base), str(cur)] + flags
    want = _run(_reference_bench_diff().main, argv)
    got = _run(bench_diff.main, argv)
    assert got == want
    assert got[0] == code, got
