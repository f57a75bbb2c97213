"""End-to-end driver: train a ~100M-param LM on a GVEL-loaded graph
corpus; the twin of the reference's ``examples/train_lm.py``.

The full pipeline the framework exists for: text edgelist --GVEL--> CSR
--random walks--> token batches --> train_step (AdamW, remat, ckpt).

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
  (the default is the reduced config; --full-width uses the ~100M one)

The reference loads the graph with its host parser; the port loads it on
the device, into the same CSR.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time


def run(args) -> list:
    """The reference's steps; returns the loop's history."""
    import dataclasses

    import torch

    from ..configs import get_config, reduced_config
    from ..core import make_graph_file, read_csr
    from ..core.env import resolve_device
    from ..data.walks import walk_batch
    from ..ft.coordinator import Coordinator, FTConfig
    from ..models import init_params
    from ..train import loop as train_loop
    from ..train.optimizer import OptimizerConfig
    from ..train.state import init_state
    from ..train.step import make_train_step

    dev = resolve_device(args.device)
    if args.full_width:
        # ~100M decoder: 12 x 768 with a 32k vocab
        cfg = dataclasses.replace(
            get_config("phi4-mini-3.8b"), num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, head_dim=64, d_ff=3072,
            vocab_size=32768)
    else:
        cfg = reduced_config("phi4-mini-3.8b")

    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "corpus.el")
        v, e = make_graph_file(path, "rmat", scale=13, edge_factor=16)
        t0 = time.perf_counter()
        csr = read_csr(path, num_vertices=v, method="staged", device=dev)
        print(f"GVEL: loaded |V|={v:,} |E|={e:,} to CSR in "
              f"{time.perf_counter()-t0:.2f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    model = init_params(cfg, 0, device=dev, dtype=torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} ({n_params/1e6:.1f}M params)")

    oc = OptimizerConfig(lr=3e-4, warmup_steps=20, decay_steps=args.steps)
    step = make_train_step(cfg, oc)
    state = init_state(model)

    def src(i):
        return walk_batch(csr, cfg, args.batch, args.seq, i)
    state, hist = train_loop.run(
        state, step, src, num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        coordinator=Coordinator(FTConfig(ckpt_every=100)), log_every=20)
    print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--full-width", action="store_true",
                   help="~100M params")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
