"""front door: the window's load rate, the edges of every load the window
completes over its seconds on the host's clock (the window runs without
the profiler).  Nothing without a load in the window."""


def read(run):
    if not run.loads_s or not run.window_s:
        return None
    return len(run.loads_s) * run.edges / run.window_s
