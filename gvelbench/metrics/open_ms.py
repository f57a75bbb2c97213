"""front door: ms a load from ``open_graph`` to the first batch, on the
port's own spans: the handle's open (``gvel.open``: sniff, validate) and
the pipeline's set-up (``gvel.setup``: the file mapped, the block plan,
the accumulators, the pinned arena, the device feed, the prefetch
thread)."""
from gvelbench import program


def read(run):
    return program.span_ms(run, ("gvel.open", "gvel.setup"))
