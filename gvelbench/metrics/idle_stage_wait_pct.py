"""device: of the card's idle time inside the profiled loads' host spans
(where none of a load's records runs, as ``device_idle_pct`` has it), the
share in which the calling thread waits for staging (the load's
``gvel.wait`` spans), in percent.  The port's spans (``time.time_ns()``)
and the trace share Unix time."""
from gvelbench import program


def read(run):
    lds = program.loads(run)
    idle = waited = 0.0
    for ld in lds:
        gaps = program.idle(ld)
        waits = [(s["start_ns"] / 1e3, s["end_ns"] / 1e3)
                 for s in ld["program"]["spans"] if s["name"] == "gvel.wait"]
        idle += sum(e - s for s, e in gaps)
        waited += program.intersect(gaps, waits)
    if idle <= 0:
        return None
    return 100.0 * waited / idle
