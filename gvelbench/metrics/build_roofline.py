"""build: the least time of a load's build over ``build_device_ms``, in
percent.  The least time reads each edge's ids once, writes its target
once, reads and writes its weight, and writes the int64 offsets; the
edges are those the CSR holds (a symmetric load builds twice the
file's)."""
from gvelbench import roofline


def read(run):
    ms = run.value("build_device_ms")
    if ms is None or run.peak_bytes_per_s is None:
        return None
    least_ms = roofline.build_bytes(run.product_edges, run.num_vertices,
                                    run.weighted) \
        / run.peak_bytes_per_s * 1e3
    return 100.0 * least_ms / ms
