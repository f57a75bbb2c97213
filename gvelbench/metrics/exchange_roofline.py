"""exchange: the least time of a load's exchange over
``exchange_device_ms``, in percent.  The least time moves the busiest
card's bytes, sent or received, over one direction of its links: two int32
ids an edge whose owner is not the rank that parsed it."""
from gvelbench import roofline


def read(run):
    ms = run.value("exchange_device_ms")
    if ms is None or run.exchange_bytes is None:
        return None
    least_ms = run.exchange_bytes / roofline.link_bytes_per_s(run.kind) * 1e3
    return 100.0 * least_ms / ms
