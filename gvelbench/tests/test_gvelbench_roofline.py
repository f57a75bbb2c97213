"""The least bytes of each layer, counted by hand."""
import numpy as np
import pytest

from gvelbench import graphs, roofline, shards


def test_parse_bytes():
    # 1,000 bytes of text read once; 10 edges of two int32 ids written
    assert roofline.parse_bytes(1000, 10, False) == 1000 + 80
    # and a float32 weight each
    assert roofline.parse_bytes(1000, 10, True) == 1000 + 120


def test_build_bytes():
    # 10 edges: ids read (8 B) and target written (4 B); 4 vertices: five
    # int64 offsets
    assert roofline.build_bytes(10, 4, False) == 120 + 40
    # weights read and written: 8 B an edge more
    assert roofline.build_bytes(10, 4, True) == 200 + 40


def test_scale22_numbers():
    e = 67_108_864
    least_ms = roofline.parse_bytes(1_037_925_125, e, False) / 3.35e12 * 1e3
    assert least_ms == pytest.approx(0.470086, rel=1e-5)
    least_ms = roofline.build_bytes(e, 1 << 22, False) / 3.35e12 * 1e3
    assert least_ms == pytest.approx(0.250406, rel=1e-5)


def test_peak_is_the_data_sheets():
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(ValueError):
        roofline.peak_bytes_per_s("NVIDIA A100-SXM4-80GB")


def test_exchange_bytes_of_a_four_rank_partition():
    # moves[i, j]: edges parsed by rank i whose source rank j owns
    moves = [[5, 1, 0, 2],
             [0, 7, 3, 0],
             [4, 0, 6, 1],
             [0, 0, 0, 9]]
    # sent off the card: 3, 3, 5, 0; received: 4, 1, 3, 3; the busiest
    # card is rank 2, which sends 5 edges of two int32 ids
    assert roofline.exchange_bytes(moves) == 5 * 8
    assert roofline.exchange_bytes(moves, weighted=True) == 5 * 12
    assert roofline.exchange_bytes(np.diag([4, 4, 4, 4])) == 0


def test_moves_follow_each_newline_to_its_quarter():
    # eight 1-based lines of 4 or 5 bytes in 16-byte blocks: 34 bytes, so
    # blocks 0-2 and spans [0, 0), [0, 1), [1, 2), [2, 3) for four ranks
    cfg = {"base": 1, "geometry": {"beta": 16, "batch_blocks": 1}}
    src = np.array([0, 1, 2, 3, 9, 4, 5, 6], np.int32)
    dst = np.array([1, 2, 3, 0, 0, 9, 6, 5], np.int32)
    g = graphs.Graph(src, dst, None)
    lengths = graphs.line_lengths(g, cfg)
    assert lengths.tolist() == [4, 4, 4, 4, 5, 5, 4, 4]
    assert shards.span_blocks(34, cfg, 4) == [(0, 0), (0, 1), (1, 2),
                                              (2, 3)]
    assert shards.parse_batches(34, cfg, 4) == [0, 1, 1, 1]
    # newlines at 3, 7, 11, 15 (block 0), 20, 25, 29 (block 1), 33 (2)
    assert shards.holders(g, cfg, 34, 4).tolist() == [1, 1, 1, 1, 2, 2, 2,
                                                       3]
    # V = 10, rows = 3: owners 0, 0, 0, 1, 3, 1, 1, 2
    m = shards.moves(g, cfg, 34, 4, 10)
    assert m.tolist() == [[0, 0, 0, 0], [3, 1, 0, 0], [0, 2, 0, 1],
                          [0, 0, 1, 0]]
    # ranks 1 and 2 send 3 edges each and rank 0 receives 3: 3 at most
    assert roofline.exchange_bytes(m) == 24


def test_link_peak_is_the_data_sheets():
    assert roofline.link_bytes_per_s("NVIDIA H100 80GB HBM3") == 450e9
    with pytest.raises(ValueError):
        roofline.link_bytes_per_s("NVIDIA A100-SXM4-80GB")
