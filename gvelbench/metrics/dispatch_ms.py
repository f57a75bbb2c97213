"""front door: ms a load in which the calling thread, which feeds the
card, works on the batches without waiting for staging, on the port's own
spans: each batch (``gvel.batch``) less its wait for the prefetch thread
(``gvel.wait``).  That is the hand-off of the next batch, the
host-to-device put and its fence (``gvel.h2d``), the parse launch
(``gvel.parse``), and whatever holds the thread between them."""
from gvelbench import program


def read(run):
    batches = program.span_ms(run, ("gvel.batch",))
    if batches is None:
        return None
    return batches - (program.span_ms(run, ("gvel.wait",)) or 0.0)
