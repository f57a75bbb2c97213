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



# the sharded cell on the CPU: 4 KiB blocks, two to a batch, so that each
# of the four ranks parses a span of a scale-10 file
SMALL_GEOMETRY = {"beta": 4096, "batch_blocks": 2, "overlap": 64}


def small_blocks():
    """The port's default geometry at :data:`SMALL_GEOMETRY` (the run's
    configuration states it too)."""
    import_program()
    from repro_torch.core import loader
    _set(loader, "DEFAULT_BETA", SMALL_GEOMETRY["beta"])
    _set(loader, "DEFAULT_BATCH_BLOCKS", SMALL_GEOMETRY["batch_blocks"])
    _set(loader, "DEFAULT_OVERLAP", SMALL_GEOMETRY["overlap"])


def sharded_cpu():
    """:func:`small_blocks`, and each batch counted."""
    small_blocks()
    count_cpu_launches()


def sharded_cached():
    small_blocks()
    cached()


def sharded_half_batches():
    small_blocks()
    half_batches()


def sharded_altered():
    small_blocks()
    altered()


def no_exchange():
    """The exchange left out: every rank receives what it would send."""
    sharded_cpu()
    from repro_torch.core import distributed
    real = distributed.dist

    class Local:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def all_to_all_single(out, x, group=None):
            out.copy_(x)
    _set(distributed, "dist", Local())


def dropped_bucket():
    """Rank 1 sends rank 2 nothing: its bucket for rank 2 emptied before
    the exchange."""
    sharded_cpu()
    import os
    from repro_torch.core import distributed
    if os.environ.get("RANK") != "1":
        return
    bucket = distributed.bucket_by_owner

    def drop(*args, **kw):
        snd_src, snd_dst, snd_w, overflow = bucket(*args, **kw)
        cap = kw["send_cap"]
        snd_src[2 * cap:3 * cap] = -1
        snd_dst[2 * cap:3 * cap] = -1
        return snd_src, snd_dst, snd_w, overflow
    _set(distributed, "bucket_by_owner", drop)


def rank_exits():
    """Rank 2 exits in its second load, while the others wait for it."""
    sharded_cpu()
    import os
    from repro_torch.core import distributed
    if os.environ.get("RANK") != "2":
        return
    stream = distributed.stream_shards
    calls = [0]

    def exit_early(*args, **kw):
        calls[0] += 1
        if calls[0] == 2:
            os._exit(3)
        return stream(*args, **kw)
    _set(distributed, "stream_shards", exit_early)
