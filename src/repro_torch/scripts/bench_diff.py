"""Compare two benchmark JSON files row by row; nonzero exit on a perf
regression.  The port's own copy of the reference's
``scripts/bench_diff.py``: the same CLI, messages and exit codes, on the
same ``name``/``speedup`` rows (the port's benchmark writes them).

Rows are matched by ``name`` and compared on their ``speedup`` field
(gain over a baseline row of the same run, so the comparison is
self-normalized against host speed).  Two modes, combinable:

* tolerance mode (default): every row of BASELINE present in CURRENT
  must keep ``current.speedup >= baseline.speedup * (1 - tol)``.
  Meaningful when both files come from the *same* benchmark
  configuration.  ``--rows`` restricts the checked rows by glob.
* floor mode (``--require NAME>=X``, repeatable): absolute speedup
  floors on CURRENT rows, the cross-configuration gate.

``--require-only`` skips tolerance comparisons entirely.  A row named
in ``--require`` (or matched by ``--rows``) that is missing from
CURRENT is a regression; other baseline rows missing from CURRENT are
warnings.

    python -m repro_torch.scripts.bench_diff BASE.json NEW.json --tol 0.25
    python -m repro_torch.scripts.bench_diff BASE.json NEW.json \
        --require-only --require 'e2e.load_csr_streaming>=1.0'
"""
from __future__ import annotations

import argparse
import fnmatch
import json
import sys


def _load(path: str) -> dict:
    with open(path) as f:
        rows = json.load(f)
    if not isinstance(rows, list) or not all(
            isinstance(r, dict) and "name" in r and "speedup" in r
            for r in rows):
        sys.exit(f"{path}: expected a list of rows with name/speedup "
                 f"fields (benchmarks/e2e_load_csr.py --json output)")
    return {r["name"]: r for r in rows}


def _parse_require(spec: str) -> tuple[str, float]:
    name, _, floor = spec.partition(">=")
    if not name or not floor:
        sys.exit(f"--require expects NAME>=FLOOR, got {spec!r}")
    try:
        return name.strip(), float(floor)
    except ValueError:
        sys.exit(f"--require floor must be a number, got {floor!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench_diff.py",
        description="Diff two benchmark JSON files; exit 1 on regression")
    ap.add_argument("baseline")
    ap.add_argument("current")
    ap.add_argument("--tol", type=float, default=0.25,
                    help="allowed relative speedup drop per row "
                    "(default 0.25 = 25%%)")
    ap.add_argument("--rows", default="*",
                    help="comma-separated name globs to tolerance-check "
                    "(default: all)")
    ap.add_argument("--require", action="append", default=[],
                    metavar="NAME>=X", help="absolute speedup floor on a "
                    "CURRENT row (repeatable)")
    ap.add_argument("--require-only", action="store_true",
                    help="skip tolerance comparisons; only check --require "
                    "floors (cross-configuration mode)")
    args = ap.parse_args(argv)

    base, cur = _load(args.baseline), _load(args.current)
    globs = [g.strip() for g in args.rows.split(",") if g.strip()]
    requires = dict(_parse_require(s) for s in args.require)
    failures, lines = [], []

    for name, floor in requires.items():
        row = cur.get(name)
        if row is None:
            failures.append(f"{name}: required row missing from "
                            f"{args.current}")
            continue
        ok = row["speedup"] >= floor
        lines.append(f"  {name}: speedup {row['speedup']:.2f} "
                     f"(floor {floor:.2f}) {'ok' if ok else 'REGRESSION'}")
        if not ok:
            failures.append(f"{name}: speedup {row['speedup']:.2f} below "
                            f"required floor {floor:.2f}")

    if not args.require_only:
        for name, brow in base.items():
            if not any(fnmatch.fnmatch(name, g) for g in globs):
                continue
            crow = cur.get(name)
            if crow is None:
                if name in requires:
                    continue              # already reported above
                lines.append(f"  {name}: missing from current (warning)")
                continue
            limit = brow["speedup"] * (1.0 - args.tol)
            ok = crow["speedup"] >= limit
            lines.append(
                f"  {name}: {brow['speedup']:.2f} -> {crow['speedup']:.2f} "
                f"(min {limit:.2f}) {'ok' if ok else 'REGRESSION'}")
            if not ok:
                failures.append(
                    f"{name}: speedup fell {brow['speedup']:.2f} -> "
                    f"{crow['speedup']:.2f} (tolerance {args.tol:.0%})")

    print(f"bench_diff: {args.baseline} vs {args.current}")
    for ln in lines:
        print(ln)
    if failures:
        print("bench_diff: PERF REGRESSION", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("bench_diff: no regression")
    return 0


if __name__ == "__main__":
    sys.exit(main())
