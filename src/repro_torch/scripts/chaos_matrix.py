"""Seeded chaos matrix for the port: drive the fault-injection harness
(:mod:`repro_torch.core.faults`) through the recovery paths and fail loudly
when a self-healing contract regresses.

The port's twin of ``scripts/chaos_matrix.py``.  Scenarios, each seeded,
each printing one OK line:

  transient-retry   streaming and cached loads under injected transient
                    OSErrors and latency retry to a bitwise-equal result
  stuck-reader      a stalled block source raises StageTimeout naming its
                    byte span within the (lowered) watchdog budget
  quarantine-swap   a CRC-corrupt CSR frame on disk quarantines
                    (path, section) with a structured CorruptGraphError
                    while sibling sections and other graphs serve, and a
                    swap on disk recovers
  sigterm-resume    a walk-corpus consumer SIGTERMed mid-stream exits at
                    the step boundary with a durable cursor, and a restart
                    resumes the stream bitwise (``ft.Coordinator``)
  shard-reexec      a shard of the sharded load whose in-span retries run
                    out re-executes its byte span, bitwise equal to the
                    fault-free load; one that never recovers raises
                    ShardLoadError on every rank.  Runs a world of 2 ranks
                    on ``--device`` (gloo, or NCCL with a card per rank);
                    like the reference's, only when asked for

    python -m repro_torch.scripts.chaos_matrix                 # on CUDA
    python -m repro_torch.scripts.chaos_matrix --device cpu
    python -m repro_torch.scripts.chaos_matrix --scenario stuck-reader
    python -m repro_torch.scripts.chaos_matrix --scenario shard-reexec
"""
from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

from repro_torch.core import (convert_to_csr, faults, load_edgelist,
                              make_graph_file, open_graph, save_snapshot)
from repro_torch.core import snapshot as snapmod
from repro_torch.core.cache import SourceCache
from repro_torch.core.faults import (CorruptGraphError, FaultPlan, FaultSpec,
                                     ShardLoadError, StageTimeout, fault_plan)

LOCAL_SCENARIOS = ("transient-retry", "stuck-reader", "quarantine-swap",
                   "sigterm-resume")
ALL_SCENARIOS = LOCAL_SCENARIOS + ("shard-reexec",)
SHARD_WORLD = 2


def _graph(tmp, name, seed, *, scale=8, kind="rmat"):
    el = os.path.join(tmp, name + ".el")
    v, _e = make_graph_file(el, kind, scale=scale, edge_factor=4, seed=seed)
    return el, v


def _zlib_snapshot(tmp, name, seed, device):
    """A small-frame zlib ``.gvel``: one corrupt frame is a section-local
    event, so the quarantine's scope shows."""
    el, v = _graph(tmp, name, seed, scale=7)
    elist = load_edgelist(el, num_vertices=v, base=1, device=device)
    gv = os.path.join(tmp, name + ".gvel")
    save_snapshot(gv, edgelist=elist, csr=convert_to_csr(elist),
                  compress="zlib", frame_beta=128)
    return gv, v


def corrupt_section(path, section_name):
    """Flip one byte inside the named section's compressed payload, past
    the first frame header (a CRC or decode failure at the next read)."""
    with open(path, "rb") as f:
        hdr = f.read(snapmod.HEADER_LEN)
    _, version, _, _, _, nsec, _ = struct.unpack(snapmod.HEADER_FMT, hdr)
    if version != snapmod.VERSION_COMPRESSED:
        raise ValueError(f"{path}: not a compressed (v2) snapshot")
    want = {v: k for k, v in snapmod.SECTION_NAMES.items()}[section_name]
    with open(path, "rb") as f:
        f.seek(snapmod.HEADER_LEN)
        table = f.read(nsec * snapmod.SECTION_LEN_V2)
    for i in range(nsec):
        sid, _, off, nbytes, _, _, _ = struct.unpack_from(
            snapmod.SECTION_FMT_V2, table, i * snapmod.SECTION_LEN_V2)
        if sid == want:
            pos = off + 12 + min(13, max(0, nbytes - 13))
            with open(path, "r+b") as f:
                f.seek(pos)
                b = f.read(1)
                f.seek(pos)
                f.write(bytes([b[0] ^ 0x40]))
            return
    raise ValueError(f"{section_name} not found in {path}")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _bitwise(a, b, what):
    _require(np.array_equal(a.offsets.cpu().numpy(), b.offsets.cpu().numpy()),
             f"{what}: offsets differ")
    _require(np.array_equal(a.targets.cpu().numpy(), b.targets.cpu().numpy()),
             f"{what}: targets differ")


def scenario_transient_retry(tmp, seed, device):
    """Transient faults at the block, mmap and open sites; the loads recover
    bitwise equal to the fault-free runs."""
    faults.reset_counters()
    el, v = _graph(tmp, "tr", seed)
    clean = open_graph(el, num_vertices=v, device=device).csr()
    plan = FaultPlan([FaultSpec("block", "oserror", index=0, times=2),
                      FaultSpec("block", "latency", index=1, delay_s=0.005),
                      FaultSpec("mmap", "latency", times=1, delay_s=0.005)],
                     seed=seed)
    faulty = open_graph(el, num_vertices=v, device=device,
                        faults=plan).csr()
    _bitwise(clean, faulty, "transient-retry streaming")
    _require(plan.injected().get("block:oserror") == 2,
             f"block faults injected: {plan.injected()}")
    c = faults.counters()
    _require(c["io_retries"] >= 2, f"io retries: {c}")

    # a cold open through the cache that fails transiently still serves
    gv, _ = _zlib_snapshot(tmp, "tr_snap", seed, device)
    cache = SourceCache(capacity=2)
    with fault_plan(FaultPlan([FaultSpec("open", "oserror", times=2)],
                              seed=seed)):
        got = cache.query(gv, "csr", device=device)
    st = cache.stats()["faults"]
    _require(st["open_retries"] == 2, f"open retries: {st}")
    _require(got.num_vertices > 0, "cached csr served")
    print(f"chaos[transient-retry]: {c['io_retries']} IO retries + "
          f"{st['open_retries']} open retries, results bitwise equal OK")


def scenario_stuck_reader(tmp, seed, device):
    """A stalled block source trips the watchdog within its budget, as a
    StageTimeout naming the byte span."""
    faults.reset_counters()
    el, v = _graph(tmp, "stuck", seed)
    budget, saved = 0.4, faults.WATCHDOG_S
    faults.WATCHDOG_S = budget
    plan = FaultPlan([FaultSpec("block", "stall", index=0, delay_s=3.0)],
                     seed=seed)
    t0 = time.perf_counter()
    try:
        open_graph(el, num_vertices=v, device=device, faults=plan).csr()
        raise AssertionError("stuck reader did not raise StageTimeout")
    except StageTimeout as exc:
        dt = time.perf_counter() - t0
        _require("byte span [" in str(exc), str(exc))
        _require(dt < budget + 1.0, f"watchdog fired late: {dt:.2f}s")
    finally:
        faults.WATCHDOG_S = saved
    _require(faults.counters()["stage_timeouts"] == 1,
             f"stage timeouts: {faults.counters()}")
    print(f"chaos[stuck-reader]: StageTimeout in {dt:.2f}s "
          f"(budget {budget}s) OK")


def scenario_quarantine_swap(tmp, seed, device):
    """A corrupt CSR frame -> a structured quarantine; siblings serve; a
    swap on disk recovers."""
    live, v = _zlib_snapshot(tmp, "live", seed, device)
    other, _ = _zlib_snapshot(tmp, "other", seed + 1, device)
    backup = live + ".bak"
    shutil.copyfile(live, backup)
    cache = SourceCache(capacity=4)
    deg = cache.query(live, "degree", vertex=1, device=device)
    cache.invalidate()

    corrupt_section(live, "csr_indices")
    try:
        cache.query(live, "csr", device=device)
        raise AssertionError("corrupt section served")
    except CorruptGraphError as exc:
        _require(exc.section == "csr_indices", exc.section)
    try:
        cache.query(live, "neighbors", vertex=1, device=device)
        raise AssertionError("quarantined section served")
    except CorruptGraphError as exc:
        _require("quarantined" in str(exc), str(exc))
    # header-only and offsets-only ops, and the other graph, keep serving
    _require(cache.query(live, "info", device=device).num_vertices == v,
             "info serves")
    _require(cache.query(live, "degree", vertex=1, device=device) == deg,
             "degree serves")
    _require(cache.query(other, "csr", device=device).num_vertices > 0,
             "the other graph serves")
    st = cache.stats()["faults"]
    _require(st["quarantines"] == 1 and bool(st["quarantined"]), str(st))

    os.replace(backup, live)                 # swap the good bytes back
    os.utime(live)
    got = cache.query(live, "csr", device=device)
    _require(got.num_vertices == v, "swapped file serves")
    st = cache.stats()["faults"]
    _require(st["recovered"] >= 1 and not st["quarantined"], str(st))
    print(f"chaos[quarantine-swap]: csr_indices quarantined "
          f"({st['corrupt_errors']} structured errors), siblings served, "
          f"swap recovered OK")


_SIGTERM_CHILD = r'''
import hashlib, sys
from repro_torch.core.source import open_graph
from repro_torch.data.corpus import (CorpusConfig, WalkCorpus, load_cursor,
                                     save_cursor)
from repro_torch.ft.coordinator import Coordinator, FTConfig
gv, cursor, log, total, seed, device = (sys.argv[1], sys.argv[2], sys.argv[3],
                                        int(sys.argv[4]), int(sys.argv[5]),
                                        sys.argv[6])
cc = CorpusConfig(batch=4, seq=16, vocab_size=97, seed=seed)
start = load_cursor(cursor) or 0
with Coordinator(FTConfig(handle_signals=True)) as coord:
    with WalkCorpus(open_graph(gv, device=device), cc).batches(start) as stream:
        while stream.next_step < total:
            step, batch = next(stream)
            h = hashlib.sha256(batch["tokens"].cpu().numpy().tobytes())
            with open(log, "a") as f:
                f.write(f"{step} {h.hexdigest()}\n")
            save_cursor(cursor, stream.next_step)
            print(step, flush=True)
            if coord.should_stop():
                sys.exit(3)                 # preempted: clean cursor exit
sys.exit(0)
'''


def _child_env():
    import repro_torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def scenario_sigterm_resume(tmp, seed, device):
    """SIGTERM mid-stream -> durable cursor -> bitwise-stitched resume:
    a child streams a ``WalkCorpus`` under a signal-handling
    ``Coordinator``, logging each batch's hash and saving the cursor; it is
    SIGTERMed after step 2 and must exit 3 at the step boundary; a restart
    resumes at the cursor, and the stitched log equals the uninterrupted
    stream's hashes."""
    from repro_torch.data.corpus import CorpusConfig, WalkCorpus, load_cursor
    dev = device or "cuda"
    el, v = _graph(tmp, "sig", seed, scale=7)
    gv = os.path.join(tmp, "sig.gvel")
    open_graph(el, num_vertices=v, device=dev).save(gv)
    cursor = os.path.join(tmp, "cursor")
    log = os.path.join(tmp, "log")
    total = 12
    env = _child_env()

    def spawn():
        return subprocess.Popen(
            [sys.executable, "-c", _SIGTERM_CHILD, gv, cursor, log,
             str(total), str(seed), dev],
            stdout=subprocess.PIPE, text=True, env=env)

    p = spawn()
    for line in p.stdout:                   # SIGTERM mid-stream
        if int(line) >= 2:
            p.send_signal(signal.SIGTERM)
            break
    p.wait(timeout=120)
    _require(p.returncode == 3,
             f"expected preempted exit 3, got {p.returncode}")
    resumed_at = load_cursor(cursor)
    _require(bool(resumed_at) and resumed_at < total, str(resumed_at))
    p = spawn()                             # restart resumes at the cursor
    p.communicate(timeout=300)
    _require(p.returncode == 0, str(p.returncode))

    with open(log) as f:
        steps, hashes = zip(*(ln.split() for ln in f))
    _require([int(s) for s in steps] == list(range(total)), str(steps))
    corpus = WalkCorpus(open_graph(gv, device=dev),
                        CorpusConfig(batch=4, seq=16, vocab_size=97,
                                     seed=seed))
    for step, h in zip(steps, hashes):      # vs uninterrupted reference
        want = hashlib.sha256(corpus.batch_at(int(step))["tokens"].cpu()
                              .numpy().tobytes()).hexdigest()
        _require(h == want, f"step {step}: {h} != {want}")
    print(f"chaos[sigterm-resume]: SIGTERM at step {resumed_at - 1}, "
          f"resume at {resumed_at}, {total}-batch stream bitwise "
          f"identical OK")


def scenario_shard_reexec(tmp, seed, device):
    """Exhausted in-span retries escalate to a re-execution of the shard's
    whole span, bitwise equal to the fault-free sharded load; run in a
    world of :data:`SHARD_WORLD` ranks (:func:`shard_reexec_rank`)."""
    from repro_torch.scripts import local_world
    el, _v = _graph(tmp, "shard", seed)
    env = _child_env()
    runs = local_world.spawn(
        [sys.executable, "-m", "repro_torch.scripts.chaos_matrix",
         "--seed", str(seed), "--device", device or "cuda",
         "--shard-rank-of", el], SHARD_WORLD, timeout=600, env=env,
        workdir=tmp)
    for k, run in enumerate(runs):
        _require(run.returncode == 0,
                 f"shard-reexec rank {k} exited {run.returncode}:\n"
                 f"{run.stdout}{run.stderr}")
    oks = [ln for run in runs for ln in run.stdout.splitlines()
           if ln.startswith("rank ")]
    _require(len(oks) == SHARD_WORLD, f"rank reports: {oks}")
    print(f"chaos[shard-reexec]: d={SHARD_WORLD}, 1 shard re-execution "
          f"bitwise equal, ShardLoadError on every rank with a "
          f"{faults.SHARD_RETRIES + 1}-line fault log on the failed one OK")


def shard_reexec_rank(el, seed, device):
    """One rank of ``shard-reexec``: block 0 (shard 0's first) fails three
    times, which exhausts the in-span retries (``REPRO_IO_RETRIES=3``) and
    re-executes shard 0 once; then a block that never recovers."""
    import torch
    from repro_torch.scripts import local_world
    dev_type = "cpu" if device == "cpu" else "cuda"
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = "gloo"
    if dev_type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        if cards >= world:
            backend = "nccl"          # NCCL takes one card per rank
    mesh, rank, world = local_world.join(backend, dev_type)
    try:
        faults.reset_counters()
        clean = open_graph(el, beta=2048, device=dev_type).csr_sharded(mesh)
        plan = FaultPlan([FaultSpec("block", "oserror", index=0, times=3)],
                         seed=seed)
        faulty = open_graph(el, beta=2048, device=dev_type,
                            faults=plan).csr_sharded(mesh)
        _bitwise(clean, faulty, f"shard-reexec rank {rank}")
        c = faults.counters()
        _require(c["shard_retries"] == (1 if rank == 0 else 0), str(c))
        _require(plan.injected() == ({"block:oserror": 3} if rank == 0
                                     else {}), str(plan.injected()))
        with fault_plan(FaultPlan([FaultSpec("block", "oserror", index=0,
                                             times=-1)], seed=seed)):
            try:
                open_graph(el, beta=2048,
                           device=dev_type).csr_sharded(mesh)
                raise AssertionError("a permanently failing shard loaded")
            except ShardLoadError as exc:
                _require(exc.shard == 0, f"failed shard {exc.shard}")
                if rank == 0:
                    _require(len(exc.fault_log) == faults.SHARD_RETRIES + 1,
                             f"fault log {exc.fault_log}")
    finally:
        local_world.leave()
    print(f"rank {rank}/{world}: {c['shard_retries']} shard re-execution(s), "
          f"bitwise equal OK")


SCENARIOS = {
    "transient-retry": scenario_transient_retry,
    "stuck-reader": scenario_stuck_reader,
    "quarantine-swap": scenario_quarantine_swap,
    "sigterm-resume": scenario_sigterm_resume,
    "shard-reexec": scenario_shard_reexec,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scripts.chaos_matrix",
        description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", choices=ALL_SCENARIOS, action="append",
                    help="run only these (default: the local ones, all "
                    "but shard-reexec)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="where the loads run (default CUDA; 'cpu' runs "
                    "the plain PyTorch versions)")
    ap.add_argument("--shard-rank-of", metavar="EDGELIST",
                    help=argparse.SUPPRESS)     # a rank of shard-reexec
    args = ap.parse_args(argv)
    if args.shard_rank_of:
        shard_reexec_rank(args.shard_rank_of, args.seed, args.device)
        return 0
    names = args.scenario or list(LOCAL_SCENARIOS)
    tmp = tempfile.mkdtemp(prefix="gvel_chaos_")
    try:
        for name in names:
            SCENARIOS[name](tmp, args.seed, args.device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"chaos matrix: {len(names)} scenario(s) green "
          f"(seed={args.seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
