"""build: ms a load after the last batch, on the port's own spans: the
host's syncs for the edge and vertex counts (``gvel.sync``), the shrink
and the build's launches (``gvel.build``), and the wait for the card to
finish the product (``gvel.complete``)."""
from gvelbench import program


def read(run):
    return program.span_ms(run, ("gvel.sync", "gvel.build", "gvel.complete"))
