"""Training loop: train_step + FT coordinator; the port of
``repro/train/loop.py``.

The loop owns nothing model-specific: it is handed a step, a
step-indexed batch source, and a checkpoint directory, and provides
checkpoint/restart (atomic + async), deterministic data replay,
straggler observation, and preemption-safe shutdown.  ``float(loss)``
waits for the step on the card: it is the step barrier.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..checkpoint import io as ckpt_io
from ..ft.coordinator import Coordinator, FTConfig
from .state import TrainState


def run(
    state: TrainState,
    train_step: Callable,
    batch_source: Callable[[int], dict],
    *,
    num_steps: int,
    ckpt_dir: Optional[str] = None,
    ft: Optional[FTConfig] = None,
    coordinator: Optional[Coordinator] = None,
    log_every: int = 10,
    log: Callable[[str], None] = print,
):
    # a WalkCorpus (repro_torch.data.corpus) is a batch source: its
    # batch_at(step) is the pure step-indexed function this loop's
    # deterministic-replay contract requires
    batch_source = getattr(batch_source, "batch_at", batch_source)
    coord = coordinator or Coordinator(ft or FTConfig())
    start = int(state.step)
    history = []
    pending_ckpt = None

    step = start
    while step < num_steps:
        t0 = time.perf_counter()
        coord.maybe_fail(step)
        batch = batch_source(step)
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])        # blocks; also the step barrier
        dt = time.perf_counter() - t0
        action = coord.observe_step(dt)
        if action == "straggler-rebatch":
            # deterministic source -> same data; re-run the step shape
            log(f"[ft] straggler at step {step}; rebatching")
        history.append({"step": step, "loss": loss, "dt": dt, **{
            k: float(v) for k, v in metrics.items() if k != "loss"}})
        if step % log_every == 0:
            log(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        step += 1
        if ckpt_dir and coord.should_checkpoint(step):
            if pending_ckpt is not None:
                pending_ckpt.join()
            pending_ckpt = ckpt_io.save(state, ckpt_dir, step, async_=True)
        if coord.should_stop():
            log(f"[ft] preempted; checkpointing at step {step} and exiting")
            if ckpt_dir:
                if pending_ckpt is not None:
                    pending_ckpt.join()
                ckpt_io.save(state, ckpt_dir, step)
            break
    if pending_ckpt is not None:
        pending_ckpt.join()
    return state, history


def resume_or_init(template: TrainState, init_fn: Callable[[], TrainState],
                   ckpt_dir: Optional[str]):
    """Restart path: restore the latest checkpoint into ``template`` if one
    exists, else ``init_fn()``.  Returns ``(state, step)``."""
    if ckpt_dir:
        step = ckpt_io.latest_step(ckpt_dir)
        if step is not None:
            state, _ = ckpt_io.restore(template, ckpt_dir, step)
            return state, step
    return init_fn(), 0
