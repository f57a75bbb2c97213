"""The port's benchmark: one run of one cell.

    python -m gvelbench.run --workload graph500-s22.csr --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout that holds the port (``src/repro_torch``) and
``BENCHMARK.json``.  Prints progress lines, then one JSON object as the
last line of standard output, and the numbers compared for ``correct``
with their limits as the last lines of standard error.  Exits 2 without
a CUDA device or with fewer than the cell asks for, and 1 when the run
cannot finish or a process loaded jax or the JAX package; neither prints
a result.
"""
import time

T0 = time.monotonic()          # the set-up clock starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from .harness import BenchError, NoDevice, forbidden_modules, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gvelbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, found = run(args.workload, args.seed, args.seconds,
                            bool(args.trace), t0=T0,
                            say=lambda m: print(m, flush=True))
    except BenchError as exc:
        print(f"gvelbench: {exc}", file=sys.stderr)
        return 2 if isinstance(exc, NoDevice) else 1
    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        print(f"gvelbench: modules of jax or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
