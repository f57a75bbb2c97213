"""host staging and H2D: ms a load in which the calling thread, which
feeds the card, waits for the prefetch thread's next batch
(``gvel.wait``), on the port's own spans."""
from gvelbench import program


def read(run):
    return program.span_ms(run, ("gvel.wait",))
