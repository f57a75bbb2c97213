"""build: device ms a load of the card's work that starts after the load's
last parse record ends, copies excluded (the vertex count, the staged
build's sorts, histogram, scan and scatters)."""
from gvelbench import trace


def _parse_end(run, load):
    parse = run.module("parse_device_ms")
    ends = [e for (n, s, e) in load["records"] if parse.claim((n, s, e),
                                                              load)]
    return max(ends) if ends else None


def make_claim(run):
    cache = {}

    def claim(rec, load):
        key = id(load)
        if key not in cache:
            cache[key] = _parse_end(run, load)
        end = cache[key]
        return end is not None and rec[1] >= end and \
            trace.is_card_work(rec[0])
    return claim


def read(run):
    return run.device_ms(make_claim(run))
