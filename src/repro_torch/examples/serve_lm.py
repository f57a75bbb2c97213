"""Serve a small model with batched requests (continuous batching
engine); the twin of the reference's ``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse

ARGS = ["--arch", "phi4-mini-3.8b", "--reduced", "--requests", "12",
        "--max-new", "24", "--batch", "4", "--max-seq", "96"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    from ..launch.serve import main as serve_main
    return serve_main(ARGS + ([] if args.device is None
                              else ["--device", args.device]))


if __name__ == "__main__":
    raise SystemExit(main())
