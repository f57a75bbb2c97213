"""device: ms a load in which a kernel or a memset of the load runs on the
card, the union of those records (copies left out: they wait on the
host's memory).  It sums every layer's kernels, so it claims no records
of its own."""
from gvelbench import trace


def read(run):
    return run.covered_ms(trace.is_card_work)
