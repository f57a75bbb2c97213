"""Convert a text edgelist or MatrixMarket file to a ``.gvel`` snapshot.

The port's twin of ``scripts/convert.py``: GVEL's "write once, load many".
The text is parsed once here, on the card unless ``--device cpu``; every
later load of the output reads it without a parse (and, with the default
embedded CSR, without a build)::

    python -m repro_torch.scripts.convert graph.el graph.gvel
    python -m repro_torch.scripts.convert --weighted --base 0 g.el g.gvel
    python -m repro_torch.scripts.convert matrix.mtx matrix.gvel --device cpu

It is ``open_graph(input, ...).save(output, ...)`` followed by an eager
re-read that checksums every section.  Formats are sniffed by magic; an MTX
file's field and symmetry come from its banner.  Exit codes: 0 converted,
1 an input, option or read error, 2 the output exists and ``--force`` was
not given.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scripts.convert",
        description="Convert a text edgelist / MTX file to a .gvel snapshot")
    ap.add_argument("input", help="text edgelist or MatrixMarket file")
    ap.add_argument("output", help="output .gvel path")
    ap.add_argument("--weighted", action="store_true",
                    help="parse a third weight column (text inputs; MTX "
                    "weighting comes from the banner)")
    ap.add_argument("--symmetric", action="store_true",
                    help="materialize reverse edges (text inputs; MTX "
                    "symmetry comes from the banner)")
    ap.add_argument("--base", type=int, default=1, choices=(0, 1),
                    help="vertex-id base of the text input (default 1)")
    ap.add_argument("--num-vertices", type=int, default=None,
                    help="|V| override for text inputs (default max id + 1, "
                    "which drops isolated trailing vertices); MTX inputs "
                    "take |V| from the size line")
    ap.add_argument("--engine", default="device",
                    help="parse engine for the conversion read (default "
                    "device; see repro_torch.core.available_engines())")
    ap.add_argument("--no-csr", action="store_true",
                    help="store only the packed edgelist, not a prebuilt CSR")
    ap.add_argument("--method", default="staged", choices=("staged", "global"),
                    help="CSR build strategy for the embedded CSR")
    ap.add_argument("--rho", type=int, default=4,
                    help="partitions for the staged CSR build")
    ap.add_argument("--compress", default=None, metavar="CODEC[:LEVEL]",
                    help="store sections compressed (.gvel v2): zlib always, "
                    "zstd when the zstandard package is installed; e.g. "
                    "--compress zlib or --compress zstd:9")
    ap.add_argument("--device", default=None,
                    help="where the parse and build run (default CUDA; "
                    "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--force", action="store_true",
                    help="overwrite an existing output file")
    args = ap.parse_args(argv)

    if os.path.exists(args.output) and not args.force:
        print(f"error: refusing to overwrite existing {args.output} "
              f"(pass --force to replace it)", file=sys.stderr)
        return 2

    from repro_torch.core import open_graph, read_snapshot

    try:
        t0 = time.perf_counter()
        # a format probe only: the open below, with the engine pinned,
        # validates the headers once
        src = open_graph(args.input, validate=False, device=args.device)
        if src.format == "mtx":
            ignored = [name for name, off_default in
                       [("--weighted", not args.weighted),
                        ("--symmetric", not args.symmetric),
                        ("--base", args.base == 1),
                        ("--num-vertices", args.num_vertices is None)]
                       if not off_default]
            if ignored:
                print(f"warning: {', '.join(ignored)} ignored for MTX input "
                      f"-- field/symmetry/base/|V| come from the MTX header",
                      file=sys.stderr)
            src = open_graph(args.input, engine=args.engine,
                             device=args.device)
        else:
            src = open_graph(args.input, engine=args.engine,
                             weighted=args.weighted,
                             symmetric=args.symmetric, base=args.base,
                             num_vertices=args.num_vertices,
                             device=args.device)
        out = src.save(args.output, compress=args.compress,
                       csr=not args.no_csr, method=args.method, rho=args.rho)
        # decompress and checksum every section of what was written now,
        # not at some consumer's first access
        read_snapshot(args.output)
        t_convert = time.perf_counter() - t0
    except (OSError, ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    info = out.info()
    in_sz = os.path.getsize(args.input)
    comp = f" codec={info.codec}" if info.codec else ""
    print(f"{args.input} ({in_sz / 1e6:.2f} MB) -> {args.output} "
          f"({info.size_bytes / 1e6:.2f} MB, "
          f"{info.size_bytes / max(in_sz, 1):.2f}x input)"
          f"{comp} in {t_convert * 1e3:.0f} ms")
    print(f"  |V|={info.num_vertices:,} |E|={info.num_edges:,} "
          f"v{info.version} weighted={info.weighted} "
          f"edgelist={info.has_edgelist} csr={info.has_csr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
