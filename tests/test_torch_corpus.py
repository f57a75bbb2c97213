"""The port's walk corpus held against ``repro.data.corpus`` on the same
text file, on the CPU: step-indexed batches bitwise, the prefetch stream,
bitwise resume, the degrade prefix and the cursor.  The reference loads
the file through ``repro.core.open_graph``; the port with
``device="cpu"``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import make_graph_file
from repro.core import open_graph as jax_open
from repro.data.corpus import CorpusConfig as JaxConfig
from repro.data.corpus import WalkCorpus as JaxCorpus
from repro_torch import open_graph
from repro_torch.data.corpus import (CorpusConfig, WalkCorpus, load_cursor,
                                     save_cursor)
from repro_torch.data.pipeline import graph_walk_source

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CC = dict(batch=4, seq=8, vocab_size=64, seed=5)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "g.el")
    make_graph_file(path, "rmat", scale=7, edge_factor=6, seed=2)
    return path


def _corpus(path, **kw):
    return WalkCorpus(open_graph(path, device="cpu"),
                      CorpusConfig(**{**CC, **kw}))


def test_batch_at_matches_reference(graph):
    ref = JaxCorpus(jax_open(graph), JaxConfig(**CC))
    port = _corpus(graph)
    for step in (0, 3):
        want, got = ref.batch_at(step), port.batch_at(step)
        for name in ("tokens", "labels"):
            assert got[name].dtype == torch.int32
            assert got[name].shape == (CC["batch"], CC["seq"])
            assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
    want = ref.batch_at(2, batch=2)["tokens"]
    assert np.array_equal(port.batch_at(2, batch=2)["tokens"].numpy(),
                          np.asarray(want))


def test_stream_resume_and_degrade(graph):
    c = _corpus(graph)
    with c.batches(0) as stream:
        seen = [next(stream) for _ in range(6)]
        assert stream.next_step == 6
    assert [s for s, _ in seen] == list(range(6))
    for step, batch in seen:
        assert torch.equal(batch["tokens"], c.batch_at(step)["tokens"])
    with _corpus(graph).batches(start_step=3, device="cpu") as stream:
        for want_step, want in seen[3:]:
            step, batch = next(stream)
            assert step == want_step
            assert torch.equal(batch["tokens"], want["tokens"])
            assert torch.equal(batch["labels"], want["labels"])
    assert torch.equal(c.batch_at(1, batch=2)["tokens"],
                       seen[1][1]["tokens"][:2])


def test_corpus_pins_the_csr_once(graph):
    src = open_graph(graph, device="cpu")
    c = WalkCorpus(src, CorpusConfig(**CC))
    c.batch_at(0)
    offsets = c._offsets
    c.batch_at(1)
    assert c._offsets is offsets is src.csr().offsets


def test_cursor_roundtrip_and_missing(tmp_path):
    p = str(tmp_path / "cursor.json")
    assert load_cursor(p) is None
    save_cursor(p, 17)
    assert load_cursor(p) == 17
    save_cursor(p, 18)
    assert load_cursor(p) == 18
    assert os.listdir(tmp_path) == ["cursor.json"]


def test_graph_walk_source_routes_through_corpus(graph):
    class Cfg:
        vocab_size = 64

    fn = graph_walk_source(graph, Cfg, 4, 8, seed=5, device="cpu")
    want = _corpus(graph).batch_at(2)
    assert torch.equal(fn(2)["tokens"], want["tokens"])


def test_consumers_import_no_jax_in_a_fresh_process(tmp_path):
    """The consumer path (gather, point reads, walks, corpus) pulls in
    neither jax nor the JAX package."""
    p = tmp_path / "g.el"
    p.write_bytes(b"1 2\n2 3\n3 1\n1 3\n")
    code = f"""
import sys
import torch
import repro_torch
from repro_torch.data.corpus import CorpusConfig, WalkCorpus
src = repro_torch.open_graph({str(p)!r}, device="cpu")
csr = src.csr()
nbrs, deg = repro_torch.kernels.neighbor_gather(
    torch.tensor([0, 1, 2], dtype=torch.int32), csr.offsets, csr.targets,
    width=4)
assert deg.tolist() == [2, 1, 1], deg
assert src.neighbors(0).tolist() == [1, 2]
batch = WalkCorpus(src, CorpusConfig(batch=2, seq=3)).batch_at(0)
assert batch["tokens"].shape == (2, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
