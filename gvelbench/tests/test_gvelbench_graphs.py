"""The generators and the writer: bytes from the seed alone, the
sources' parameters, text that reads back as the arrays."""
import numpy as np
import pytest

from gvelbench import graphs, harness

CONFIGS = ("graph500-s22", "gap-urand-s22-w")


def small(name, scale=10):
    cfg = harness.read_json(harness.HERE / "configs" / f"{name}.json")
    return dict(cfg, scale=scale)


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_bytes_whatever_the_threads(name, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(graphs, "CHUNK", 1 << 11)     # 8 chunks at scale 10
    cfg = small(name)
    out = []
    for workers in (1, 3, 8):
        path = tmp_path / f"g{workers}.el"
        g = graphs.make(cfg, 2**33 + 5, str(path), workers=workers)
        out.append((path.read_bytes(), g.src.copy(), g.dst.copy()))
    assert out[0][0] == out[1][0] == out[2][0]
    assert all(np.array_equal(out[0][1], o[1]) for o in out)
    other = graphs.make(cfg, 2**33 + 6, str(tmp_path / "x.el"), workers=3)
    assert not np.array_equal(other.src, out[0][1])


def test_graph500_parameters_are_the_specs():
    cfg = small("graph500-s22", scale=22)
    assert (cfg["generator"], cfg["a"], cfg["b"], cfg["c"]) == \
        ("rmat", 0.57, 0.19, 0.19)
    assert (cfg["edge_factor"], cfg["permute"], cfg["weights"]) == \
        (16, True, "none")
    assert cfg["published"]["scale"] == 26


def test_gap_urand_parameters_are_the_suites():
    cfg = small("gap-urand-s22-w", scale=22)
    assert (cfg["generator"], cfg["edge_factor"], cfg["weights"]) == \
        ("urand", 16, "uniform_int")
    assert cfg["weight_range"] == [1, graphs.WEIGHT_MAX] == [1, 255]
    assert cfg["published"]["scale"] == 27


def test_rmat_is_skewed_and_urand_is_not():
    g = graphs.make(small("graph500-s22", 14), 3)
    u = graphs.make(small("gap-urand-s22-w", 14), 3)
    for x in (g, u):
        assert x.num_edges == 16 << 14
        assert 0 <= x.src.min() and x.src.max() < 1 << 14
    deg_g = np.bincount(g.src, minlength=1 << 14)
    deg_u = np.bincount(u.src, minlength=1 << 14)
    assert deg_g.max() > 20 * 16 and deg_u.max() < 4 * 16
    assert (deg_g == 0).mean() > 0.2 > (deg_u == 0).mean()
    w = u.weights
    assert w.dtype == np.float32 and w.min() >= 1 and w.max() <= 255
    assert set(np.unique(w)) == set(np.arange(1, 256, dtype=np.float32))


@pytest.mark.parametrize("name", CONFIGS)
def test_text_reads_back_as_the_arrays(name, tmp_path):
    cfg = small(name)
    path = tmp_path / "g.el"
    g = graphs.make(cfg, 11, str(path))
    rows = np.loadtxt(path, dtype=np.int64, ndmin=2)
    assert np.array_equal(rows[:, 0], g.src + 1)
    assert np.array_equal(rows[:, 1], g.dst + 1)
    if g.weights is not None:
        assert np.array_equal(rows[:, 2], g.weights.astype(np.int64))
    text = path.read_bytes()
    assert text.endswith(b"\n") and b"  " not in text and b"\r" not in text
