"""device: the share of the profiled loads' host spans in which no record
of the load (kernel, copy, memset) runs on the card, in percent."""


def read(run):
    busy, window = run.busy_window_s()
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
