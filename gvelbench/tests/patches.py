"""Changes to the program made inside a test run (the harness's
``patch``): a launch count on the CPU, where the plain parse counts none,
and the faults that the benchmark has to catch.  :func:`undo` puts back
what they changed (a run runs in the test's own process)."""
from gvelbench.harness import import_program

_SAVED = []


def _set(obj, name, value):
    _SAVED.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def undo():
    while _SAVED:
        obj, name, value = _SAVED.pop()
        setattr(obj, name, value)


def count_cpu_launches():
    """Count each batch of the plain parse as the card's kernel would."""
    import_program()
    from repro_torch.core import loader
    from repro_torch.kernels import _lib
    parse = loader.parse_accumulate

    def counted(*args, **kw):
        _lib.LAUNCHES["parse_accumulate"] += 1
        return parse(*args, **kw)
    _set(loader, "parse_accumulate", counted)


def cached():
    """A load answered from a cache: every load after the first gets the
    first handle back, whose products are memoized."""
    count_cpu_launches()
    import repro_torch
    opened = {}
    open_graph = repro_torch.open_graph

    def memo(path, **kw):
        if path not in opened:
            opened[path] = open_graph(path, **kw)
        return opened[path]
    _set(repro_torch, "open_graph", memo)


def half_batches():
    """Every second batch of the parse left out."""
    count_cpu_launches()
    from repro_torch.core import loader
    parse = loader.parse_accumulate
    calls = [0]

    def skip(acc_src, acc_dst, acc_w, total, *args, **kw):
        calls[0] += 1
        if calls[0] % 2 == 0:
            return acc_src, acc_dst, acc_w, total
        return parse(acc_src, acc_dst, acc_w, total, *args, **kw)
    _set(loader, "parse_accumulate", skip)


def altered():
    """The first parsed edge of every load gets another target."""
    count_cpu_launches()
    from repro_torch.core import loader
    parse = loader.parse_accumulate

    def alter(acc_src, acc_dst, acc_w, total, *args, **kw):
        first = int(total) == 0
        out = parse(acc_src, acc_dst, acc_w, total, *args, **kw)
        if first:
            out[1][0] += 1
        return out
    _set(loader, "parse_accumulate", alter)

