"""host staging and H2D: ms a load in which the prefetch thread stages
batches (``gvel.stage``: the copy out of the file's map, the newline fill,
the line check, and any wait for the slot's copy), on the port's own
spans."""
from gvelbench import program


def read(run):
    return program.span_ms(run, ("gvel.stage",))
