"""front door: the 75th percentile of the window's loads, each timed on
the host's clock from ``open_graph`` to the card's synchronize (the window
runs without the profiler).  ``statistics.quantiles``' exclusive method;
nothing with fewer than four loads."""
import statistics


def read(run):
    if len(run.loads_s) < 4:
        return None
    return statistics.quantiles(run.loads_s, n=4)[2]
