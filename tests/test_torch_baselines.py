"""The paper's baseline loaders in the port held against the JAX package's
(``repro.core.baselines``) on the CPU, at tolerance 0: the naive line
loop, ``np.loadtxt``, PIGO's two passes at 1, 3 and 8 workers, and PIGO's
single-stage CSR, over weighted and unweighted files at base 0 and 1 --
and each against the port's own host engine where the semantics agree.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import edgelist as jedgelist
from repro_torch.core import baselines, edgelist, load_csr

import torch_serving as ts

CPU = {"device": "cpu"}


def _text(seed, base, weighted, *, v=120, e=1500, comments=False):
    """Edge lines of ``v`` vertices (the last 5 isolated), 3-decimal
    weights, negative among them; '#' comment lines when ``comments``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v - 5, e) + base
    dst = rng.integers(0, v - 5, e) + base
    w = np.round(rng.random(e) * 20 - 5, 3)
    lines = []
    for i in range(e):
        if comments and i % 97 == 0:
            lines.append("# a comment 1 2")
        line = f"{src[i]} {dst[i]}"
        if weighted:
            line += f" {w[i]:.3f}"
        lines.append(line)
    return ("\n".join(lines) + "\n").encode()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("baselines")
    out = {}
    for base in (0, 1):
        for weighted in (False, True):
            for comments in (False, True):
                p = tmp / f"g{base}{int(weighted)}{int(comments)}.el"
                p.write_bytes(_text(base * 2 + weighted, base, weighted,
                                    comments=comments))
                out[base, weighted, comments] = str(p)
    return out


def _same_el(got, want):
    assert got.src.device.type == "cpu" and got.src.dtype == torch.int32
    assert int(got.num_edges) == int(want.num_edges)
    assert int(got.num_vertices) == int(want.num_vertices)
    assert ts.same(got.src, want.src) and ts.same(got.dst, want.dst)
    assert ts.same(got.weights, want.weights)


CASES = [(base, weighted, comments) for base in (0, 1)
         for weighted in (False, True) for comments in (False, True)]


@pytest.mark.parametrize("base,weighted,comments", CASES)
def test_naive_matches_reference(files, base, weighted, comments):
    p = files[base, weighted, comments]
    for kw in ({}, {"num_vertices": 130}):
        got = baselines.read_edgelist_naive(p, weighted=weighted, base=base,
                                            **kw, **CPU)
        _same_el(got, jbaselines.read_edgelist_naive(
            p, weighted=weighted, base=base, **kw))
    want = jedgelist.read_edgelist_numpy(p, weighted=weighted, base=base)
    assert ts.same(got.src, want.src) and ts.same(got.dst, want.dst)


@pytest.mark.parametrize("base,weighted,comments", CASES)
def test_loadtxt_matches_reference(files, base, weighted, comments):
    p = files[base, weighted, comments]
    _same_el(baselines.read_edgelist_loadtxt(p, weighted=weighted, base=base,
                                             **CPU),
             jbaselines.read_edgelist_loadtxt(p, weighted=weighted,
                                              base=base))


@pytest.mark.parametrize("num_workers", [1, 3, 8])
@pytest.mark.parametrize("base,weighted,comments", CASES)
def test_pigo_matches_reference(files, num_workers, base, weighted, comments):
    p = files[base, weighted, comments]
    got = baselines.read_edgelist_pigo(p, weighted=weighted, base=base,
                                       num_workers=num_workers, **CPU)
    _same_el(got, jbaselines.read_edgelist_pigo(
        p, weighted=weighted, base=base, num_workers=num_workers))
    _same_el(got, edgelist.read_edgelist_numpy(p, weighted=weighted,
                                               base=base, **CPU))


@pytest.mark.parametrize("base,weighted", [(0, False), (1, True)])
def test_csr_pigo_matches_reference(files, base, weighted):
    p = files[base, weighted, True]
    el = baselines.read_edgelist_pigo(p, weighted=weighted, base=base, **CPU)
    jel = jbaselines.read_edgelist_pigo(p, weighted=weighted, base=base)
    got = baselines.csr_pigo(el, **CPU)
    assert got.offsets.dtype == torch.int64 and got.offsets.device.type == "cpu"
    assert ts.same_csr(got, jbaselines.csr_pigo(jel))
    host = load_csr(p, engine="numpy", weighted=weighted, base=base, **CPU)
    assert ts.same_csr(got, host)
