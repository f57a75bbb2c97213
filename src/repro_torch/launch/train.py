"""Training entry point; the port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      [--reduced] [--device cpu] --steps 100 --batch 8 --seq 128 \\
      [--graph path/to/edgelist] [--ckpt-dir DIR]

Runs on CUDA unless ``--device cpu``, with f32 master weights drawn on
the device from ``--seed``.  Data comes from the GVEL pipeline (``--graph``:
a random-walk corpus over the graph, loaded on the device) or the
deterministic synthetic stream.  The reference loads ``--graph`` with its
host parser (``engine="numpy"``); the port has none and loads it with
its device engine, whose CSR equals the reference's bitwise.
"""
from __future__ import annotations

import argparse
import functools


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="phi4-mini-3.8b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--remat", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--graph", default=None,
                   help="edgelist file -> GVEL random-walk corpus")
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import torch

    from ..configs import get_config, reduced_config
    from ..data.synthetic import synthetic_batch
    from ..ft.coordinator import Coordinator, FTConfig
    from ..models import init_params
    from ..train import loop as train_loop
    from ..train.optimizer import OptimizerConfig
    from ..train.state import init_state
    from ..train.step import make_train_step

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    oc = OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                         decay_steps=args.steps)

    model = init_params(cfg, args.seed, device=args.device,
                        dtype=torch.float32)
    state = init_state(model, compression=args.compress_grads)

    if args.ckpt_dir:
        state, start = train_loop.resume_or_init(
            state, lambda: state, args.ckpt_dir)
        if start:
            print(f"resumed from step {start}")

    if args.graph:
        from ..data.pipeline import graph_walk_source
        source = graph_walk_source(args.graph, cfg, args.batch, args.seq,
                                   device=model.device)
    else:
        source = functools.partial(synthetic_batch, cfg, args.batch,
                                   args.seq, device=model.device)

    step_fn = make_train_step(cfg, oc, remat_policy=args.remat,
                              compression=args.compress_grads,
                              accum_steps=args.accum)
    with Coordinator(FTConfig(ckpt_every=args.ckpt_every,
                              handle_signals=True)) as coord:
        state, history = train_loop.run(
            state, step_fn, source, num_steps=args.steps,
            ckpt_dir=args.ckpt_dir, coordinator=coord)
    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(f"done: loss {first:.4f} -> {last:.4f} over {len(history)} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
