"""bucketing: device ms a rank's load of the card's work, NCCL's and copies
left out, from the end of its last parse record to the start of its first
``all_to_all`` record (NCCL's ``SendRecv``), averaged over the ranks'
loads: the vertex count, ``bucket_histogram``'s count and
``bucket_by_owner``'s one-hot ``cumsum``, gather and scatters."""
from gvelbench import trace


def _is_nccl(name):
    return name.startswith(("ncclDevKernel", "ncclKernel"))


def _window(run, load):
    parse = run.module("parse_device_ms")
    ends = [e for (n, s, e) in load["records"] if parse.claim((n, s, e),
                                                              load)]
    sends = [s for (n, s, e) in load["records"]
             if _is_nccl(n) and "SendRecv" in n]
    if not ends or not sends:
        return None
    return max(ends), min(sends)


def make_claim(run):
    cache = {}

    def claim(rec, load):
        key = id(load)
        if key not in cache:
            cache[key] = _window(run, load)
        win = cache[key]
        return win is not None and rec[1] >= win[0] and rec[2] <= win[1] \
            and trace.is_card_work(rec[0]) and not _is_nccl(rec[0])
    return claim


def read(run):
    return run.device_ms(make_claim(run))
