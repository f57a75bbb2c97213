"""host staging and H2D: the prefetch thread's staging rate where the work
happens, the bytes it staged (the ``bytes_staged`` counter) over its time
in ``gvel.stage`` less the waits for a slot's copy inside it
(``gvel.stage.fence``), over the profiled loads with a record; GB/s."""
from gvelbench import program


def read(run):
    lds = program.loads(run)
    staged = sum(ld["program"]["counters"].get("bytes_staged", 0)
                 for ld in lds)
    busy_ns = sum(program.span_ns(ld, ("gvel.stage",))
                  - program.span_ns(ld, ("gvel.stage.fence",)) for ld in lds)
    if staged <= 0 or busy_ns <= 0:
        return None
    return staged / busy_ns
