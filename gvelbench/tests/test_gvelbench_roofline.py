"""The least bytes of each layer, counted by hand."""
import pytest

from gvelbench import roofline


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
