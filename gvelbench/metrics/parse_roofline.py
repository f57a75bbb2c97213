"""parse: the least time of a load's parse over ``parse_device_ms``, in
percent.  The least time reads the file's bytes once and writes each
edge's ids (and weight) once at the card's memory bandwidth."""
from gvelbench import roofline


def read(run):
    ms = run.value("parse_device_ms")
    if ms is None or run.peak_bytes_per_s is None:
        return None
    least_ms = roofline.parse_bytes(run.file_bytes, run.edges, run.weighted) \
        / run.peak_bytes_per_s * 1e3
    return 100.0 * least_ms / ms
