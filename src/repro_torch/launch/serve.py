"""Serving entry point: batched decode with the slot-based engine; the port of
``repro/launch/serve.py`` and the twin of ``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      [--reduced] [--device cpu] --requests 16 --max-new 32

Runs on CUDA unless ``--device cpu``; weights are random, drawn on the
device from ``--seed``.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="phi4-mini-3.8b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import time

    import numpy as np
    import torch

    from ..configs import get_config, reduced_config
    from ..models import init_params
    from ..serve.engine import Request, ServeEngine

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.embed_stub:
        print("audio arch: decode consumes code ids (frontend stub)")
    model = init_params(cfg, args.seed, device=args.device)
    eng = ServeEngine(cfg, model, batch=args.batch, max_seq=args.max_seq,
                      device=model.device)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        eng.submit(Request(i, prompt, args.max_new))

    t0 = time.perf_counter()
    ticks = eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in eng.completed)
    where = torch.cuda.get_device_name(model.device) \
        if model.device.type == "cuda" else "CPU"
    print(f"served {len(eng.completed)} requests / {toks} tokens in {ticks} "
          f"ticks, {dt:.2f}s ({toks / dt:.1f} tok/s on {where})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
