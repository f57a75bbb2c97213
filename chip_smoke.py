#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one card and check it.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --parent DIR   # also time DIR's kernels in turns
    python3 chip_smoke.py --cards 4  # the sharded load and data-parallel,
                                     # tensor-parallel and FSDP training
                                     # and the local step at fsdp=True
                                     # over NCCL, 4 cards
    python3 chip_smoke.py --cards 4 --only launch   # one of those

Needs one CUDA device of compute capability >= 9.0 and the CUDA toolkit
(the kernels are built from ``src/repro_torch/csrc`` at first use).  It
imports neither jax nor the JAX package.  Without a CUDA device it exits 2,
without the repository beside it 3, and prints no result either way.

Phases (any failure exits non-zero):

1. build the kernels and hold each against its plain PyTorch version on
   small inputs (``parse_accumulate`` over three batches into garbage
   accumulators, weighted and not; the histogram on sorted runs, padded
   partitions, sizes around its chunk and tile, views at every 4-byte
   alignment and 2-D rows; the gather at widths 5, 33, 128 and 1000 with
   batches around its group of 32 ids; ``linear_scan`` forward and reverse
   at T in {1, 7, 256, 300}, 2 x C threads below and above one block, a
   zero and a random h0, within ``SCAN_TOL`` of its plain version, bitwise
   the sequential torch loop on the card, and its gradients against the
   plain version's autograd);
2. make RMAT text graphs with Graph500's parameters from a seed: scale 22
   (4,194,304 vertices, 67,108,864 edges, 1-based), a weighted scale-18
   file and a gzip scale-18 file; cached under ``build/repro_torch``;
3. the main path: ``repro_torch.open_graph(path).csr(method=m)`` for
   ``staged``, ``global``, ``binned`` and ``staged`` once more on the
   scale-22 file, and the default method on the two scale-18 files;
   every CSR is held bitwise
   against a numpy oracle (stable argsort).  The kernels' launch counts
   are set to 0 just before each run and read just after; every kernel
   of the load must have launched in every run;
3b. the CSR's consumers on the scale-22 CSR, with the launch counts set
   to 0 just before and read just after (``neighbor_gather`` must have
   launched): ``kernels.neighbor_gather`` at width 128 on 2**20 uniform
   ids and on the sources of 2**20 uniformly drawn edges, each bitwise
   against its plain version; point reads (``neighbors``, ``degree``,
   ``csr(rows=)``) against the oracle; 65,536 random walks of 80 steps,
   the first 1,024 bitwise against the port's CPU run, every step an edge
   or a dead-end self-loop, and split into two batches bitwise; a
   ``WalkCorpus`` streamed 8 steps and resumed from step 4 bitwise, and
   its cursor saved and read back;
3c. snapshots, framed text and MTX on the card, each run with the launch
    counts set to 0 just before it and read just after: ``save`` the
    scale-22 text as a raw v1 ``.gvel`` (edgelist + CSR, the CSR built on
    the card by ``convert_to_csr``) and as a ``zlib:1`` v2 ``.gvel``; reopen
    each and load its embedded CSR twice (the second timed), bitwise against
    the text-loaded CSR and the oracle; an edgelist-only snapshot through
    stream + ``staged`` build (histogram and scan must launch); a framed
    zlib scale-20 text file through the streaming loader (the cut to scale
    20 is in the setup: compressing 1 GB of text on the host would dominate
    the phase); a symmetric ``real`` MTX file at scale 18, its CSR against an
    oracle of the expanded edges; point reads on the ``zlib:1`` snapshot and
    its ``frame_cache_stats()``; ``neighbor_gather`` at width 128 on 2**20
    ids over the snapshot-loaded CSR, bitwise against the text CSR's;
3d. (run last, after phase 5, on phase 3c's files) the query-serving
    cache and the fault plan: a ``SourceCache(capacity=4)`` over the raw
    and ``zlib:1`` snapshots and the scale-22 text; the text's cold ``csr``
    query with the launch counts set to 0 just before and read just after
    (every kernel of the load must launch); 8 threads asking a fresh cache
    for one cold CSR at once (one open, the same CSR); 20,000 requests on
    4 threads (60% ``neighbors``, 10% ``degree``, 25% ``rows`` of under
    V/64 rows, 4% ``info``, 1% ``csr``), timed per request and in all,
    then every answer held bitwise against the oracle on the card; the
    same kind of request answered naively (open, full CSR, slice) on a
    sample of 20; the raw snapshot swapped for another graph's (answers
    from the new file, one invalidation); two transient block faults on
    the text load (retried, bitwise); a bit flipped in a ``csr_indices``
    frame half-way through the ``zlib:1`` section's copy to the card
    (``CorruptGraphError`` naming the section, ``degree`` and ``info``
    still served, a swap of the same bytes lifting the quarantine); and a
    stalled reader under a 1 s watchdog (``StageTimeout`` naming the byte
    span within 2 s, the next load bitwise);
3e. (run after 3d) the sharded load and the tuner, each run with the
    launch counts set to 0 just before it and read just after: a world of
    one rank over NCCL (a ``file://`` rendezvous) in this process loads the
    scale-22 text through ``open_graph(p).csr_sharded(mesh)`` twice (the
    second timed; ``parse_accumulate``, ``degree_histogram`` and
    ``exclusive_scan`` must launch in each) and 3c's framed scale-20 text
    once, each bitwise against the oracle in the reference's row layout;
    a world of two ranks over gloo, both on ``cuda:0`` and spawned as
    subprocesses of this script (``--shard-rank``; the kernels are built
    by then), loads the scale-22 text twice in each rank, the parent
    holding each rank's rows bitwise against the oracle's, and each rank
    then runs ``shard-reexec`` (block 0 fails three times; shard 0
    re-executes once) bitwise against its clean rows.  That world tests
    the exchange at d > 1 on the card; it is not a deployment (NCCL takes
    one card per rank, and the machine has one).  Then the tuner: with a
    fresh profile under ``build/repro_torch``, ``open_graph(p22,
    tune=True).csr()`` sweeps on the card once (``run_sweep`` counted
    through a wrapper here), later tuned loads read the profile, and
    default and tuned loads are timed in turns (default, tuned, tuned,
    default), every CSR bitwise;
3f. (run last, after 3e) walk-LM serving at phi4-mini-3.8b's full width
    (32 layers, d_model 3072, 24/8 heads of 128, SwiGLU 8192, vocab
    200,064; 3,836,018,688 parameters, bf16 weights drawn on the card
    from the seed): argmax takes the first of maxima tied at the served
    vocab size; a ``ServeRuntime(batch=8, max_seq=128,
    SourceCache(capacity=4), prompt_len=8)`` over 3c's raw ``.gvel``
    snapshot and the scale-22 text serves 32 requests alternating between
    them, 32 new tokens each, and drains; the launch counts are set to 0
    just before the text's first request and read just after it
    (``parse_accumulate``, ``degree_histogram`` and ``exclusive_scan`` must
    launch); every request completes with 32 tokens; each prompt equals
    the port's ``random_walks`` on the card for its ``(seed, rid)`` and
    every walk step is an edge or a dead-end self-loop; for 4 requests,
    every decode step's logits equal ``forward_prefill`` on the card over
    the prompt and the tokens so far, with no cache, within ``LOGIT_TOL``
    and the greedy tokens agree wherever the prefill's top-2 margin
    exceeds it, with cuBLAS's bf16 reduced-precision reduction on (the
    default) and again off; then tokens/s of the drain, decode-step ms
    from CUDA events with its spread, launches and device ms per decode
    step from the profiler, the step's bound (the bf16 weights and the KV
    cache over 3.35 TB/s), the device's busy share over a traced drain,
    the text graph's cold load inside its first request, and peak memory;
3g. (run last, after 3f) the remaining serving kinds at their published
    widths, one arch at a time, each freed before the next, bf16 weights
    drawn on the card from the seed: mixtral-8x22b (MoE, 8 of 56 layers),
    llama4-maverick-400b-a17b (MoE, 1 of 48 layers), recurrentgemma-2b
    (RG-LRU), falcon-mamba-7b (Mamba), llama-3.2-vision-11b
    (cross-attention) and musicgen-large (frame inputs), each depth cut
    printed under ``reduced`` with its reason.  For each, a
    ``ServeRuntime(batch=8, max_seq=128, prompt_len=8)``: mixtral serves 16
    requests of 32 tokens alternating between 3c's raw snapshot and the
    scale-22 text (the text's first request loads cold, its
    ``parse_accumulate``, ``degree_histogram`` and ``exclusive_scan``
    launches counted), the others 8 requests of 16 tokens on the raw
    snapshot; every request completes and every prompt is the port's walk.
    Then 2 sequences prefill 8 tokens and decode 24 steps fed their own
    greedy tokens, outside the engine (whose prefill by decode steps moves
    a recurrent slot's state), each step's logits against an uncached
    ``forward_prefill`` of the same prefix within ``LOGIT_TOL`` (MoE at
    ``capacity_factor = E / top_k``: nothing drops; steps whose prefix a
    router near a tie sent to another expert on one path are counted and
    left out; the VLM with random ``image_embeds``, musicgen with random
    ``frames``).  Then one batch-8 decode step timed as in 3f beside its
    bound (the weights and caches read once), launches and device ms a step
    from the profiler, and peak memory;
3h. (run last, after 3g, which frees the card first) LM training:
    ``repro_torch.launch.train.main`` in this process at phi4-mini-3.8b's
    full width and depth (3,836,021,760 parameters, f32 master weights
    drawn on the card from the seed, ``--batch 8 --seq 128 --steps 8
    --remat full``) over the scale-22 text through ``graph_walk_source``:
    the launch counts are set to 0 just before the call and read just after
    (``parse_accumulate``, ``degree_histogram`` and ``exclusive_scan`` must
    launch in the text load inside the first step, timed by a wrapper);
    every loss finite, step 0's within 2 of ln V; the step ms (host clock
    around each step, which ends in ``float(loss)``) and its median after 2
    warm-up steps, tokens/s, and the step's bound (the FLOPs of
    ``launch.accounting.step_flops`` over 989 TFLOP/s bf16, then the
    clip's and AdamW's 36 bytes a parameter over 3.35 TB/s; also with the
    recomputed forward).  Then, from a fresh init, 6 steps on one fixed walk batch at lr
    1e-3 (recorded: it diverges at this width) and, from another, at 3e-5,
    which must lower the loss below 0.8 of its first value; one more step
    traced (launches, device ms, the busy share); peak memory.  Then each of the six kinds' reduced archs
    (phi4-mini, mixtral, recurrentgemma, falcon-mamba, llama-3.2-vision,
    musicgen) on the card against the same f32 weights on the CPU: every
    leaf's gradient, then one step's loss, gradient norm and params, with
    cuBLAS's bf16 reduced-precision reduction on and off (the recurrent
    archs' scans and their backward run ``linear_scan`` on the card and the
    plain version on the CPU: 6 launches a recurrent layer, counted).
    Then, on the reduced phi4-mini: 6 steps checkpointed at steps 3 and 6,
    restored at 3 and replayed (losses within 1e-5), ``accum_steps=2``
    against 1 on one batch, and ``--compress-grads`` through the entry
    point carrying a nonzero error buffer.  Its numbers are under
    ``train_lm`` in the JSON;
3i. (run last, after 3h) data-parallel training, its numbers under
    ``train_dp`` in the JSON.  (b) First a world of two ranks over gloo,
    both on this one card (a test of the d > 1 arithmetic, not a
    deployment), spawned as subprocesses of this script (``--dp-rank``), at
    the reduced phi4-mini: ``compressed_allreduce`` against its plain
    single-process version (payloads and result bitwise, within 0.03 and,
    ``compressed_psum``, 0.01 of the exact sum); the local-accumulation,
    int8 and ZeRO-1 steps against the single-card step from the same
    weights (params within the reference tests' bounds, moments within
    ``CARD_GRAD_TOL`` of each leaf's largest magnitude, loss and gradient
    norm); each mode's params bitwise equal on both ranks after 3 steps; a
    ZeRO-1 state saved at step 2, restored and replayed bitwise; the
    param-shaped state saved at step 3.  Then, in an NCCL world of one in
    this process: that state ``reshard_restore``d with ``fsdp=True``, every
    leaf bitwise; and (a) phi4-mini-3.8b at full width and depth (f32
    master weights from the seed, batch 8 x 128 over walks of the scale-22
    text, ``accum_steps=2``, ``remat="full"``), the launch counts set to 0
    just before the text load and read just after (``parse_accumulate``,
    ``degree_histogram`` and ``exclusive_scan`` must launch), 4 ZeRO-1
    steps, then 4 int8 steps from a fresh init (step ms, the median of
    steps 2-3, tokens/s, peak memory, the collectives' calls and bytes in
    the last step), then step 0 of ``make_train_step`` from the same seed
    on the same batch against the ZeRO-1 step's (loss within 1e-5, gradient
    norm within 1e-3, six leaves within rtol 5e-3, atol 5e-5); one state on
    the card at a time.  ``--cards N`` ends with a world of N ranks over
    NCCL, one card each, training phi4-mini-3.8b at full width (4 ZeRO-1
    steps, 4 int8 steps; losses and params equal on every rank);
3j. (run last, after 3i) tensor-parallel execution, its numbers under
    ``tp`` in the JSON.  (a) A world of two ranks over gloo on this one
    card (``--tp-rank``, mesh ``(1, 2)``; a test of the tp arithmetic,
    not a deployment): each of the 10 reduced archs from
    ``init_params(cfg, SEED, tp=2)``, sharded by ``shard_model``, against
    the unsharded run of the same padded parameters in the same rank
    (cuBLAS's bf16 reduced-precision reduction off): the loss within
    5e-4, every whole gradient within 5e-2 of its leaf's largest
    magnitude, the prefill's and 8 decode steps' logits within 2e-2 beyond
    the unsharded run's own spread between the card and the CPU (the
    repo's ``LOSS_RTOL``, ``GRAD_TOL`` and ``TOL``), every cache leaf of
    the rank's shape by ``cache_pspec``; then a world of four, ``(2, 2)``:
    the reduced phi4-mini's f32, int8 and ZeRO-1 steps against
    ``make_train_step`` from the same weights (the 3i bounds).  (b)
    phi4-mini-3.8b at full width and depth, bf16, tp=2 over gloo on this
    card: each rank loads the scale-22 text (the loader's launches counted
    from 0) for 8 walk prompts of 32 tokens, prefills them and takes 16
    greedy steps (event ms a step, tokens/s, launches of a traced step,
    the collectives' calls and bytes of the last step, weight and cache
    bytes a rank, peak memory); the parent runs tp=1 on the same weights
    and prompts, and the token streams must agree wherever tp=1's top-2
    margin exceeds ``MARGIN_TOL``.  (c) phi4-mini-3.8b at full width, 4
    layers deep, f32, one local-accumulation step at tp=2 against
    ``make_train_step`` in the parent (loss within 5e-4, gradient norm
    within 1e-2);  ``--cards N`` then decodes phi4-mini-3.8b at full width
    and depth at tp=N over NCCL and trains it with the ``(1, N)`` f32 step
    and the ``(N/2, 2)`` ZeRO-1 step (2 steps each: ms, peak memory);
3k. (run last, after 3j) FSDP execution, its numbers under ``fsdp`` in the
    JSON.  (a) Worlds of ``--fsdp-rank`` ranks over gloo on this one card
    (a test of the FSDP arithmetic, not a deployment), ``(2, 1)`` and ``(2,
    2)``: each of the 10 reduced archs from ``init_params(cfg, SEED, tp)``
    sharded by ``shard_model(..., fsdp=True)`` (every rank's pieces of the
    rules' shapes; a bf16 state for ``BF16_STATE_ARCHS``), two steps of
    ``make_train_step(..., mesh=mesh)`` at ``accum_steps=2`` on a 4 x 16
    batch (an MoE's routing group spans the ranks) against the
    single-card step of the same parameters in the same rank: the first
    loss within 5e-4 and the second within 2e-3, gradient norms within
    1e-2, the first step's moments (its gradients) within 5e-2 of each
    leaf's largest magnitude, the moments f32 after every step; at ``(2,
    1)`` also the bf16 model's prefill and 8 greedy decode steps with the
    batch split over the data axis against the unsharded run, the tokens
    equal wherever its top-2 margin exceeds ``MARGIN_TOL``.  (b)
    mixtral-8x22b at full width, 1 of 56 layers, ``fsdp`` and the bf16
    state by the reference's defaults, in a gloo world of two on this
    card: each rank loads the scale-22 text (the loader's launches counted
    from 0) for a batch of 8 x 128 walks, then 2 steps (lr 3e-5,
    ``remat="full"``): losses finite and equal on both ranks, step ms, the
    collectives' calls and bytes a step, state bytes a rank, peak memory;
    then, in this process, the unsharded single-card step of the same
    model on the same batch (step 0's loss within 5e-4);
    ``--cards N`` trains it 4 of 56 layers deep at ``(N, 1)`` and ``(N/2,
    2)`` over NCCL, one rank a card;
3l. (run last, after 3k) the launch tooling, the local step at
    ``fsdp=True`` and the example twins, its numbers under ``launch`` in
    the JSON.  (b) First, in worker processes while the rest runs, the dry
    run (``launch.dryrun.run_cell`` on fake ``cuda`` tensors in a fake
    world of the production mesh) of mixtral-8x22b ``train_4k`` single
    (FSDP and the bf16 state by the reference's defaults),
    phi4-mini-3.8b ``train_4k`` single in ``local_zero1`` (both cut to one
    microbatch), phi4-mini-3.8b ``decode_32k`` multi and falcon-mamba-7b
    ``long_500k`` multi: each record's trace seconds, FLOPs a device,
    collective bytes by op, argument and temp GB beside its analytic
    terms.  (a) The examples on the card: ``quickstart`` (scale 14; the
    launch counts set to 0 just before and read just after: the load's
    three kernels must launch; its CSR against the numpy oracle),
    ``serve_lm``, ``train_lm`` (the reduced config, 60 steps: the mean
    loss of the last 10 below the first 10's) and ``distributed_load`` in
    an NCCL world of one in this process (its launches counted) and a
    gloo world of two on this card.  (c) Beside (a), phi4-mini-3.8b at
    full width, 4 of 32 layers, f32, in a gloo world of two on this card
    (``--launch-rank``, mesh ``(2, 1)``): 2 local-accumulation steps at
    ``fsdp=True`` and 2 at ``fsdp=False`` from the same weights, the first
    of each under ``launch.counters.Recorder``: the losses equal on both
    ranks and between the two runs, bitwise; the same step through the dry
    run in a fake ``(2, 1)`` world gives rank 0's collective calls and
    bytes per op and its FLOPs exactly; its argument + temp bytes beside
    the allocator's peak over the real first step.  ``--cards N`` runs
    mixtral-8x22b at full width, 1 of 56 layers, with its bf16 state at
    ``(N, 1)`` over NCCL, one rank a card, 2 local steps at ``fsdp=True``
    (the losses equal on every rank), against a fake ``(N, 1)`` world that
    stands for NCCL;
3m. (run last, after 3l) the paper's comparisons on the card's machine,
    its numbers under ``host_engines`` in the JSON, on an RMAT scale-20
    text file (3c's): GVEL on the card (``open_graph(p).csr()``, the second
    load timed, the loader's launches counted from 0); GVEL on the host,
    the ``threads`` engine at 1, 2, 4, ... workers up to the cores
    ``os.sched_getaffinity(0)`` gives (at most 32), for the edge list and
    for ``csr()``, and ``csr_staged_np`` at the same counts; the ``numpy``
    engine and its host build; PIGO (``read_edgelist_pigo`` +
    ``csr_pigo``); ``read_edgelist_loadtxt``; the Hornet / Gunrock analogue
    (``read_edgelist_naive`` + ``csr_pigo``) on a scale-18 file only (cut:
    its Python loop over the scale-20 file's 16.7 M lines would take the
    phase's budget; it is compared by edges/s); then the ``threads``
    engine's edge list loaded onto the card and built there by
    ``convert_to_csr`` (the histogram and the scan must launch), equal to
    the host build.  Every product bitwise against the numpy oracle; host
    work timed with ``device="cpu"``, one run each.  Prints seconds and
    edges/s by loader, the card path's speedup over each, the ratio for
    each doubling of threads, and the host's CPU model and cores beside
    the card's ``nvidia-smi`` line;
3n. (run last, after 3m) recurrent prefill at full width through the
    chunked scan, its numbers under ``recurrent_prefill`` in the JSON:
    falcon-mamba-7b (64 Mamba layers) and then recurrentgemma-2b (26
    layers, 18 RG-LRU), bf16 weights drawn on the card from the seed, each
    freed before the next.  Each runs ``forward_prefill`` over 2 prompts
    of 4,096 tokens (16 chunks of 256), the port's walks over 3c's raw
    snapshot mod the vocab; the launch counts set to 0 just before the
    first prefill and read just after: ``linear_scan`` launches layers x
    16 times.  Against the same model with the plain scan forced, on the
    same card: the logits within ``LOGIT_TOL`` (each layer's final state
    recorded), and each recurrent mix, run again with the plain scan on
    the kernel path's own input, its final state within
    ``LAYER_STATE_TOL`` and its output within ``LAYER_OUT_TOL``; prefill
    ms on CUDA events in turns (kernel, plain, plain, kernel), tokens/s,
    one traced prefill's launches and device ms (``linear_scan``'s among
    them), peak memory;
4. each kernel at the main path's shapes: bitwise against its plain
   version on the same inputs, then timed beside its plain version, one
   PyTorch call computing the same function (where there is one), and its
   bound (bytes moved over 3.35 TB/s).  Two times per kernel: ``ms``, CUDA
   events around back-to-back wrapper calls (the wrapper's host work
   included), and ``device_ms``, the summed duration of the device
   kernels and memsets of a window of calls in ``torch.profiler``, per
   call over the calls whose device records were all kept
   (``library_device_ms`` likewise for the library call; see
   ``TRACE_LOSSES``).  The
   histogram on both of its inputs, per load: the ``staged`` build's
   sorted (partition, source) keys over rho x V bins and the stream-order
   ids of ``global`` and ``binned`` over V, one call each;
   ``staged_merge`` on the ``staged`` build's sorted pairs and table,
   bitwise its plain version and the main path's targets, beside the
   whole build's device ms by kernel (its pair sort among them), its
   launches, and its peak above the accumulators it sorts in (bounded by
   12 B an edge and (8 rho + 12) B a vertex);
   ``parse_accumulate`` at one main-path batch against its plain path;
   ``parse_blocks`` (the parse kernel plus the per-block compaction) at
   the same batch against its CPU run; ``neighbor_gather`` on both of its
   inputs; ``linear_scan`` at falcon-mamba-7b's chunk (2, 256, 8192 x 16)
   and recurrentgemma-2b's (8, 256, 2560), within ``SCAN_TOL`` of its plain
   version and bitwise the sequential loop, its bound the bytes of a, b,
   h0 and h over 3.35 TB/s (no PyTorch call computes the recurrence).
   With ``--parent DIR`` (a checkout of another commit, e.g. a
   ``git archive`` of the parent), DIR's port is imported under another
   name, and its scan, parse, parse + packing, histogram (on both inputs),
   ``staged`` build and gather (on both inputs) are timed on the same
   inputs in turns with this tree's (parent, this, this, parent), each
   pair bitwise equal;
5. a breakdown of one scale-22 load: host staging alone, stage + copy +
   parse (the stream), parse alone on device-resident bytes, the build;
   then one load traced with ``torch.profiler`` for the device's busy
   share (the union of its kernel and copy intervals).

Prints the per-run results, then the kernels line, then the card's name
and power limit, and as the last line ``{"ok": true, "device": ...}``.
Everything is also written to ``build/repro_torch/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import gc
import gzip
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "repro_torch", "smoke_data")
OUT = os.path.join(ROOT, "build", "repro_torch")
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
MAIN_SCALE, SMALL_SCALE, EDGE_FACTOR = 22, 18, 16
FRAMED_SCALE, MTX_SCALE = 20, 18   # phase 3c's framed text and MTX file
RHO = 4                            # csr_staged's partitions (the default)
LOAD_KERNELS = ("parse_accumulate", "exclusive_scan", "degree_histogram",
                "staged_merge")
GATHER_IDS, GATHER_WIDTH = 1 << 20, 128   # width: the reference's default
NUM_WALKS, WALK_LENGTH = 65536, 81        # 80 steps (node2vec's walk length)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data: RMAT edges, a vectorised ASCII writer, the numpy oracle
# ---------------------------------------------------------------------------

def rmat_edges(scale: int, edge_factor: int, seed: int,
               a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """Graph500-style RMAT (0-based int32 ids, vertex ids permuted)."""
    rng = np.random.default_rng(seed)
    v = 1 << scale
    e = v * edge_factor
    src = np.empty(e, np.int32)
    dst = np.empty(e, np.int32)
    ab = a + b
    a_norm, c_norm = np.float32(a / ab), np.float32(c / (1.0 - ab))
    chunk = 1 << 22
    for lo in range(0, e, chunk):
        n = min(chunk, e - lo)
        s = np.zeros(n, np.int32)
        d = np.zeros(n, np.int32)
        for bit in range(scale):
            sb = rng.random(n, dtype=np.float32) > ab
            db = rng.random(n, dtype=np.float32) > np.where(sb, c_norm, a_norm)
            s |= sb.astype(np.int32) << bit
            d |= db.astype(np.int32) << bit
        src[lo:lo + n], dst[lo:lo + n] = s, d
    perm = rng.permutation(v).astype(np.int32)
    return perm[src], perm[dst], v


def _ascii(x: np.ndarray, width: int):
    """Right-aligned decimal digits of non-negative ints, and a mask of the
    significant ones."""
    out = np.empty((len(x), width), np.uint8)
    y = x.astype(np.int64)
    for k in range(width - 1, -1, -1):
        out[:, k] = 48 + y % 10
        y //= 10
    nd = 1 + sum((x >= 10 ** k).astype(np.int64) for k in range(1, width))
    keep = np.arange(width)[None, :] >= (width - nd)[:, None]
    return out, keep


def _column(byte: int, n: int):
    return np.full((n, 1), byte, np.uint8), np.ones((n, 1), bool)


def write_edgelist(path: str, src, dst, wint=None, frac_digits: int = 4,
                   header: bytes = b""):
    """Write ``header`` and then ``src+1 dst+1[ weight]`` lines; a weight is
    the integer ``wint`` printed with ``frac_digits`` decimals
    (``12.0345``)."""
    width = len(str(int(max(src.max(), dst.max())) + 1))
    if wint is not None:
        iwidth = len(str(int(wint.max()) // 10 ** frac_digits))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        for lo in range(0, len(src), 1 << 22):
            hi = min(lo + (1 << 22), len(src))
            n = hi - lo
            parts = [_ascii(src[lo:hi] + 1, width), _column(32, n),
                     _ascii(dst[lo:hi] + 1, width)]
            if wint is not None:
                ip, fp = np.divmod(wint[lo:hi], 10 ** frac_digits)
                frac = _ascii(fp, frac_digits)[0]
                parts += [_column(32, n), _ascii(ip, iwidth), _column(46, n),
                          (frac, np.ones(frac.shape, bool))]
            parts.append(_column(10, n))
            mat = np.concatenate([p[0] for p in parts], axis=1)
            keep = np.concatenate([p[1] for p in parts], axis=1)
            f.write(mat[keep].tobytes())
    os.replace(tmp, path)


def csr_oracle(src, dst, weights, num_vertices):
    """Host oracle: numpy stable argsort (the JAX package's ``csr_np``)."""
    order = np.argsort(src, kind="stable")
    offsets = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=num_vertices), out=offsets[1:])
    return offsets, dst[order], None if weights is None else weights[order]


def make_graph(name: str, scale: int, weighted: bool, compress: bool,
               seed: int):
    """Generate (or reuse) one graph file; returns (path, src, dst, w)."""
    os.makedirs(DATA, exist_ok=True)
    path = os.path.join(DATA, name)
    arrays = path + ".npz"
    if os.path.exists(path) and os.path.exists(arrays):
        z = np.load(arrays)
        return path, z["src"], z["dst"], (z["w"] if weighted else None)
    t0 = time.perf_counter()
    src, dst, _v = rmat_edges(scale, EDGE_FACTOR, seed)
    wint = w = None
    if weighted:
        wint = np.random.default_rng(seed + 1).integers(0, 10**6, len(src))
        w = wint.astype(np.float32) / np.float32(10**4)
    text_path = path[:-3] if compress else path
    write_edgelist(text_path, src, dst, wint)
    if compress:
        with open(text_path, "rb") as fin, \
                gzip.open(path, "wb", compresslevel=1) as fout:
            shutil.copyfileobj(fin, fout, 1 << 24)
        os.remove(text_path)
    np.savez(arrays, src=src, dst=dst, w=w if weighted else np.zeros(0))
    say(f"made {name}: {len(src)} edges, {os.path.getsize(path)} bytes, "
        f"{time.perf_counter() - t0:.1f}s")
    return path, src, dst, w


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# On the card machine a trace can lose some of its device records (kineto
# counts them "out of range"), more often late in a long process: a window
# could keep most of its records, or none.  The runtime
# calls that launched the work are all kept, and a device record carries
# its launch's correlation id, so every launch can be checked for its
# record: device times are taken only over calls whose records are all
# there, and each trace's losses are counted (``TRACE_LOSSES``).  Idle host
# time on both sides of the traced work keeps records whose device clock
# runs a few ms ahead of the host's inside the window.
TRACE_PAD_S = 0.05
TRACE_LOSSES = []        # per trace: (launches, launches without a record)


@contextlib.contextmanager
def traced(torch):
    """``torch.profiler`` over the body, padded on both sides; read the
    yielded profile with :func:`card_records` after the block."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def card_records(prof):
    """``(launches, records)``: the runtime calls that put work on the
    card (kernel launches, memsets, copies) in launch order, and the
    card's records by correlation id.  Counts the launches left without
    a record."""
    from torch.autograd import DeviceType
    events = prof.events()
    launches = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.name.startswith("cu")
                       and any(k in e.name for k in
                               ("Launch", "Memset", "Memcpy"))),
                      key=lambda e: e.time_range.start)
    records = {e.id: e for e in events if e.device_type == DeviceType.CUDA}
    TRACE_LOSSES.append((len(launches),
                         sum(e.id not in records for e in launches)))
    return launches, records


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device time per call: the summed duration of the kernels, memsets
    and copies that a call of ``fn`` ran on the card, from
    ``torch.profiler``, averaged over the ``calls`` traced calls whose
    records were all kept (at least half of them must be).  Every call
    launches the same work, so the launches split into ``calls`` equal
    runs in launch order."""
    fn()
    with traced(torch) as prof:
        for _ in range(calls):
            fn()
    launches, records = card_records(prof)
    per = len(launches) // calls
    require(per > 0 and per * calls == len(launches),
            f"device_ms: {len(launches)} launches in {calls} calls alike")
    whole = []
    for i in range(calls):
        run = [records.get(e.id) for e in launches[i * per:(i + 1) * per]]
        if all(r is not None for r in run):
            whole.append(sum(r.time_range.end - r.time_range.start
                             for r in run))
    require(2 * len(whole) >= calls,
            f"device_ms: the profiler kept every record of only "
            f"{len(whole)} of {calls} calls")
    return sum(whole) / len(whole) / 1e3


def device_ms_by_name(torch, fn, calls: int = 3) -> dict:
    """Device ms a call of ``fn`` by kernel (memset, copy) name, over
    ``calls`` traced calls, largest first; only calls whose records were
    all kept count (at least one must be)."""
    fn()
    with traced(torch) as prof:
        for _ in range(calls):
            fn()
    launches, records = card_records(prof)
    per = len(launches) // calls
    require(per > 0 and per * calls == len(launches),
            f"device_ms_by_name: {len(launches)} launches in {calls} calls "
            f"alike")
    by_name, whole = {}, 0
    for i in range(calls):
        run = [records.get(e.id) for e in launches[i * per:(i + 1) * per]]
        if all(r is not None for r in run):
            whole += 1
            for r in run:
                by_name[r.name] = by_name.get(r.name, 0.0) + (
                    r.time_range.end - r.time_range.start) / 1e3
    require(whole > 0, "device_ms_by_name: no call kept every record")
    return {k: v / whole for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])}


def timed(torch, fn, iters: int = 50) -> dict:
    """``ms`` (events, back-to-back calls) and ``device_ms`` of ``fn``."""
    return {"ms": cuda_ms(torch, fn, iters), "device_ms": device_ms(torch, fn)}


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(torch, kernels, report):
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    lib_path = _lib.build()
    report["build_s"] = time.perf_counter() - t0
    say(f"built {lib_path.name} in {report['build_s']:.1f}s")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    text = (b"12345678901 2\n1 2 123456789.123\n3 4 1.2.5\n1 2 7-2\n"
            b"1 2 -\n5 6\n# c 1 2\n1 2 3 4\n7 8\r\n" * 20)
    rows = torch.full((2, 512), 10, dtype=torch.uint8)
    rows[0, :len(text[:512])] = torch.frombuffer(bytearray(text[:512]),
                                                 dtype=torch.uint8)
    rows[1] = rows[0].roll(7)
    for weighted in (False, True):
        got = kernels.parse_bytes(rows.to(dev), 0, 512, weighted=weighted,
                                  base=1)
        want = kernels.parse_bytes_ref(rows, 0, 512, weighted=weighted,
                                       base=1)
        check_bytes([t.cpu() if t is not None else None for t in got], want,
                    weighted, "parse_bytes (small)")
    # three batches packed into garbage accumulators from a total of 3
    bound = 2 * (512 // 4 + 2)
    for weighted in (False, True):
        garbage = (torch.randint(-2**31, 2**31 - 1, (3 * bound + 10,),
                                 dtype=torch.int32, generator=g),
                   torch.randint(-2**31, 2**31 - 1, (3 * bound + 10,),
                                 dtype=torch.int32, generator=g),
                   torch.randn(3 * bound + 10, generator=g))
        runs = []
        for d in ("cpu", dev):
            acc = (garbage[0].to(d, copy=True), garbage[1].to(d, copy=True),
                   garbage[2].to(d, copy=True) if weighted else None,
                   torch.tensor(3, dtype=torch.int32, device=d))
            for k in range(3):
                acc = kernels.parse_accumulate(
                    *acc, rows.roll(5 * k).to(d), 0, 512, weighted=weighted,
                    base=1, edge_bound=bound)
            runs.append([t.cpu() for t in acc if t is not None])
        require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(*runs)), "parse_accumulate (small)")
    x = torch.randint(0, 100, (5001,), dtype=torch.int32, generator=g)
    got = kernels.exclusive_scan(x.to(dev))
    want = kernels.exclusive_scan_ref(x)
    require(torch.equal(got[0].cpu(), want[0])
            and torch.equal(got[1].cpu(), want[1]), "exclusive_scan (small)")
    require(torch.equal(kernels.csr_offsets(x.to(dev)).cpu(),
                        torch.cat([want[0], want[1][None]])),
            "csr_offsets (small)")
    for what, s in hist_hazards(torch, g):
        for offset in range(4):     # views at every 4-byte alignment
            card = torch.cat([s.new_zeros(offset), s.reshape(-1)]).to(
                dev)[offset:].view(s.shape)
            require(torch.equal(
                kernels.degree_histogram(card, num_vertices=257).cpu(),
                kernels.degree_histogram_ref(s, num_vertices=257)),
                f"degree_histogram (small, {what}, offset {offset})")
    # out-of-range and negative ids, E < width, degrees above width
    for v, e, width in ((9, 5, 16), (300, 5000, 8)):
        src = torch.randint(0, v, (e,), generator=g)
        src[: e // 2] = 3
        off = torch.zeros(v + 1, dtype=torch.int64)
        off[1:] = torch.cumsum(torch.bincount(src, minlength=v), 0)
        tgt = torch.randint(0, v, (e,), dtype=torch.int32, generator=g)
        ids = torch.cat([torch.arange(-v - 3, v + 4),
                         torch.tensor([-2**31, 2**31 - 1])]).int()
        want = kernels.neighbor_gather_ref(ids, off, tgt, width=width)
        for o in (off, off.int()):
            got = kernels.neighbor_gather(ids.to(dev), o.to(dev),
                                          tgt.to(dev), width=width)
            require(torch.equal(got[0].cpu(), want[0])
                    and torch.equal(got[1].cpu(), want[1]),
                    f"neighbor_gather (small, V={v}, {o.dtype})")
    # every width path, groups of 32 ids cut short, rows at every lo % 4,
    # a hot row far wider than the width
    v, e = 70, 6000
    deg = torch.randint(0, 120, (v,), generator=g)
    deg[::5] = 0
    deg[v // 2] = 3000
    off = torch.zeros(v + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(deg, 0)
    require(len(set((off[:-1] % 4).tolist())) == 4, "lo % 4 coverage")
    tgt = torch.randint(0, v, (int(off[-1]),), dtype=torch.int32,
                        generator=g)
    ids = torch.cat([torch.arange(-v - 3, v + 4), torch.tensor(
        [-2**31, 2**31 - 1, v // 2, v // 2])]).int()
    ids = ids[torch.randperm(len(ids), generator=g)]
    for width in (5, 33, 128, 1000):
        for b in (1, 31, 33, len(ids)):
            want = kernels.neighbor_gather_ref(ids[:b], off, tgt, width=width)
            for o in (off, off.int()):
                got = kernels.neighbor_gather(ids[:b].to(dev), o.to(dev),
                                              tgt.to(dev), width=width)
                require(torch.equal(got[0].cpu(), want[0])
                        and torch.equal(got[1].cpu(), want[1]),
                        f"neighbor_gather (width {width}, B={b}, "
                        f"{o.dtype})")
    scan_checks(torch, kernels, g)
    say("phase 1: kernels build and agree with their plain versions")


# linear_scan against its plain version: the kernel steps each channel's
# recurrence in order and the plain version combines in jax's tree order,
# so they differ by f32 rounding: within SCAN_TOL of the largest state (a
# few units here).  Against the same sequential loop in torch ops on the
# card (a multiply, then an add, each rounded) the kernel is bitwise.
SCAN_TOL = 1e-5


def scan_inputs(torch, g, shape, zero_h0, dev):
    """Decays in [0.5, 1), normal inputs, a zero or normal h0."""
    b, _, c = shape
    a = torch.rand(shape, generator=g, device=dev) * 0.5 + 0.5
    x = torch.randn(shape, generator=g, device=dev)
    h0 = (torch.zeros((b, c), device=dev) if zero_h0 else
          torch.randn((b, c), generator=g, device=dev))
    return a, x, h0


def scan_err(got, want) -> float:
    """The largest difference over the largest magnitude (at least 1)."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def scan_checks(torch, kernels, g):
    """``linear_scan`` on small shapes, forward and reverse: T in {1, 7,
    256, 300}; 2 x C threads below one block of 256 and across several; a
    zero and a random h0.  Against the plain version on the CPU within
    SCAN_TOL, the sequential loop on the card bitwise, one launch a call;
    then the op's gradients (the kernel reversed) against autograd
    through the plain version."""
    dev = torch.device("cuda", 0)
    for reverse in (False, True):
        for steps in (1, 7, 256, 300):
            for channels in (5, 100, 1000):
                for zero_h0 in (True, False):
                    a, x, h0 = scan_inputs(torch, g, (2, steps, channels),
                                           zero_h0, "cpu")
                    on = [t.to(dev) for t in (a, x, h0)]
                    what = (f"linear_scan (T={steps}, C={channels}, "
                            f"{'zero' if zero_h0 else 'random'} h0, "
                            f"{'reverse' if reverse else 'forward'})")
                    kernels.reset_launches()
                    got = kernels.linear_scan(*on, reverse=reverse)
                    torch.cuda.synchronize()
                    require(kernels.LAUNCHES["linear_scan"] == 1,
                            f"{what}: one launch")
                    want = kernels.linear_scan_ref(a, x, h0, reverse)
                    require(scan_err(got.cpu(), want) <= SCAN_TOL,
                            f"{what}: within {SCAN_TOL} of the plain version")
                    require(torch.equal(got, kernels.linear_scan_loop(
                        *on, reverse=reverse)),
                        f"{what}: bitwise the sequential loop on the card")
        a, x, h0 = scan_inputs(torch, g, (2, 300, 130), False, "cpu")
        gh = torch.randn(a.shape, generator=g)
        grads = []
        for d, fn in ((dev, kernels.linear_scan),
                      ("cpu", kernels.linear_scan_ref)):
            xs = [t.to(d).requires_grad_() for t in (a, x, h0)]
            (fn(*xs, reverse=reverse) * gh.to(d)).sum().backward()
            grads.append([t.grad.cpu() for t in xs])
        for name, got, want in zip(("a", "b", "h0"), *grads):
            err = float((got - want).abs().max() / want.abs().max())
            require(err <= SCAN_TOL, f"linear_scan d{name} "
                    f"({'reverse' if reverse else 'forward'}): {err} of the "
                    f"largest against the plain version's autograd")


def hist_hazards(torch, g):
    """Small histogram inputs against ``degree_histogram.cu``'s geometry
    (16 ids a thread, 512 a warp, 4,096 a tile): sorted runs across every
    boundary, one id repeated, sorted rows that end in a run of the
    padding key V (257) with -1 and ids >= V inside, stream order, and
    sizes around the chunk and the tile; with the 2-D rows."""
    lengths = torch.randint(1, 700, (60,), generator=g)
    ids = torch.sort(torch.randint(-1, 260, (60,), generator=g)).values
    runs = torch.repeat_interleave(ids, lengths).int()
    yield "sorted runs", runs
    yield "one id", torch.full((9000,), 3, dtype=torch.int32)
    yield "one id = V", torch.full((5000,), 257, dtype=torch.int32)
    padded = torch.cat([runs, torch.full((999,), 257)]).int()
    yield "padded partition", padded
    for e in (1, 15, 16, 17, 4095, 4096, 4097, 20000):
        x = torch.randint(-1, 300, (e,), dtype=torch.int32, generator=g)
        yield f"stream E={e}", x
        yield f"sorted E={e}", torch.sort(x).values
    for rho in (1, 3, 4, 8):
        rows = torch.randint(-1, 260, (rho, 1027), dtype=torch.int32,
                             generator=g)
        rows = torch.cat([torch.sort(rows, dim=1).values,
                          torch.full((rho, 400), 257, dtype=torch.int32)], 1)
        yield f"{rho} rows of 1,427", rows


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def check_bytes(got, want, weighted, what):
    import torch
    v = want[0]
    require(torch.equal(got[0], v), f"{what}: valid")
    require(torch.equal(got[1][v], want[1][v]), f"{what}: src")
    require(torch.equal(got[2][v], want[2][v]), f"{what}: dst")
    if weighted:
        require(torch.equal(got[3][v].view(torch.int32),
                            want[3][v].view(torch.int32)), f"{what}: w")


def check_csr(csr, oracle, weighted, what):
    offsets, targets, w = oracle
    require(np.array_equal(csr.offsets.cpu().numpy(), offsets),
            f"{what}: offsets")
    require(np.array_equal(csr.targets.cpu().numpy(), targets),
            f"{what}: targets")
    if weighted:
        require(np.array_equal(csr.weights.cpu().numpy().view(np.int32),
                               w.view(np.int32)), f"{what}: weights")


def drive(torch, repro_torch, kernels, path, method, weighted, oracle,
          num_edges, what):
    """One main-path run with the launch counts, and the calls of
    ``parse_blocks`` (off the load path), zeroed just before it."""
    from repro_torch.core import parse
    torch.cuda.synchronize()
    kernels.reset_launches()
    parse.CALLS["parse_blocks"] = 0
    t0 = time.perf_counter()
    csr = repro_torch.open_graph(path, weighted=weighted).csr(method=method)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES, parse_blocks=parse.CALLS["parse_blocks"])
    require(csr.targets.is_cuda and csr.offsets.dtype == torch.int64,
            f"{what}: CSR on the card, int64 offsets")
    require(min(launches[k] for k in LOAD_KERNELS if k != "staged_merge")
            > 0 and launches["staged_merge"] == (method == "staged"),
            f"{what}: every kernel of the load launched, the merge once "
            f"and only in a staged build ({launches})")
    check_csr(csr, oracle, weighted, what)
    row = {"run": what, "method": method, "seconds": seconds,
           "edges": num_edges, "edges_per_s": num_edges / seconds,
           "launches": launches}
    say(json.dumps(row))
    return row


def walk_steps_valid(torch, walks, offsets, targets):
    """Every step of ``walks`` is an edge of the CSR, or a self-loop at a
    dead end; vectorised on the card (sorted edge keys + searchsorted)."""
    v = offsets.shape[0] - 1
    deg = offsets[1:] - offsets[:-1]
    src = torch.repeat_interleave(torch.arange(v, device=offsets.device),
                                  deg)
    keys = torch.sort(src * v + targets.long()).values
    del src
    a = walks[:, :-1].reshape(-1).long()
    b = walks[:, 1:].reshape(-1).long()
    dead = deg[a] == 0
    q = a * v + b
    at = torch.searchsorted(keys, q).clamp(max=max(keys.numel() - 1, 0))
    edge = keys[at] == q if keys.numel() else torch.zeros_like(dead)
    return bool(torch.where(dead, b == a, edge).all())


def phase_consumers(torch, repro_torch, kernels, path22, s22, oracle,
                    report):
    """The CSR's consumers on the scale-22 CSR: row gathers, point reads,
    random walks and the walk corpus.  The launch counts are set to 0 just
    before and read just after.  Returns the gather inputs and the CSR."""
    from repro_torch.data import prng, walks
    from repro_torch.data.corpus import (CorpusConfig, WalkCorpus,
                                         load_cursor, save_cursor)
    dev = torch.device("cuda", 0)
    off_np, tgt_np, _ = oracle
    g = repro_torch.open_graph(path22)
    csr = g.csr()
    v, e = csr.num_vertices, int(csr.targets.shape[0])
    rng = np.random.default_rng(SEED)
    inputs = {
        "uniform": torch.from_numpy(
            rng.integers(0, v, GATHER_IDS).astype(np.int32)).to(dev),
        "edge_sources": torch.from_numpy(
            s22[rng.integers(0, e, GATHER_IDS)]).to(dev),
    }
    row = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()

    # row gathers through the public op
    gathered = {}
    for name, ids in inputs.items():
        gathered[name] = kernels.neighbor_gather(ids, csr.offsets,
                                                 csr.targets,
                                                 width=GATHER_WIDTH)

    # point reads, the highest-degree vertex among them
    deg_np = np.diff(off_np)
    hot = int(deg_np.argmax())
    for u in (0, 1, hot, int(np.argmin(deg_np)), v // 2, v - 1):
        lo, hi = int(off_np[u]), int(off_np[u + 1])
        got = g.neighbors(u)
        require(got.is_cuda and np.array_equal(got.cpu().numpy(),
                                               tgt_np[lo:hi]),
                f"point reads: neighbors({u})")
        require(g.degree(u) == hi - lo, f"point reads: degree({u})")
    for lo, hi in ((max(hot - 2, 0), min(hot + 3, v)), (v - 100, v)):
        part = g.csr(rows=(lo, hi))
        e_lo, e_hi = int(off_np[lo]), int(off_np[hi])
        require(part.row_start == lo and np.array_equal(
            part.offsets.cpu().numpy(), off_np[lo:hi + 1] - e_lo)
            and np.array_equal(part.targets.cpu().numpy(),
                               tgt_np[e_lo:e_hi]),
                f"point reads: csr(rows=({lo}, {hi}))")

    # random walks
    key = prng.key(SEED)
    w = walks.random_walks(csr.offsets, csr.targets, key,
                           num_walks=NUM_WALKS, length=WALK_LENGTH,
                           num_vertices=v)
    whole = walks.random_walks(csr.offsets, csr.targets, key,
                               num_walks=4096, length=WALK_LENGTH,
                               num_vertices=v)
    halves = [walks.random_walks(csr.offsets, csr.targets, key,
                                 num_walks=2048, length=WALK_LENGTH,
                                 num_vertices=v, walk_offset=o)
              for o in (0, 2048)]

    # the walk corpus: stream 8 steps, resume from step 4
    cfg = CorpusConfig(batch=4096, seq=WALK_LENGTH - 1)
    corpus = WalkCorpus(g, cfg)
    torch.cuda.synchronize()
    tc = time.perf_counter()
    with corpus.batches(0) as stream:
        first = [next(stream) for _ in range(8)]
        torch.cuda.synchronize()
        corpus_s = time.perf_counter() - tc
        cursor = stream.next_step
    with WalkCorpus(g, cfg).batches(start_step=4) as stream:
        resumed = [next(stream) for _ in range(4)]
    torch.cuda.synchronize()
    consumer_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(launches["neighbor_gather"] > 0,
            f"consumers: neighbor_gather launched ({launches})")

    # checks, after the counted run
    for name, (nbrs, deg) in gathered.items():
        want = kernels.neighbor_gather_ref(inputs[name], csr.offsets,
                                           csr.targets, width=GATHER_WIDTH)
        require(torch.equal(nbrs, want[0]) and torch.equal(deg, want[1]),
                f"neighbor_gather ({name}) vs its plain version")
    require(w.is_cuda and w.shape == (NUM_WALKS, WALK_LENGTH),
            "walks: shape and device")
    cpu_walks = walks.random_walks(csr.offsets.cpu(), csr.targets.cpu(), key,
                                   num_walks=1024, length=WALK_LENGTH,
                                   num_vertices=v)
    require(torch.equal(w[:1024].cpu(), cpu_walks),
            "walks: the first 1,024 equal the CPU run bitwise")
    require(walk_steps_valid(torch, w, csr.offsets, csr.targets),
            "walks: every step is an edge or a dead-end self-loop")
    require(torch.equal(whole, torch.cat(halves)),
            "walks: 2 x 2,048 with walk_offset equal one batch of 4,096")
    require(cursor == 8, "corpus: cursor after 8 steps")
    for (step, batch), (want_step, want) in zip(resumed, first[4:]):
        require(step == want_step
                and torch.equal(batch["tokens"], want["tokens"])
                and torch.equal(batch["labels"], want["labels"]),
                f"corpus: resumed step {step} bitwise")
    require(first[0][1]["tokens"].shape == (4096, WALK_LENGTH - 1)
            and first[0][1]["tokens"].is_cuda, "corpus: batch shape")
    cursor_path = os.path.join(OUT, "corpus_cursor.json")
    save_cursor(cursor_path, cursor)
    require(load_cursor(cursor_path) == cursor, "corpus: cursor round trip")

    # walk throughput, timed apart from the counted run
    iters = 3
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(iters):
        walks.random_walks(csr.offsets, csr.targets, key,
                           num_walks=NUM_WALKS, length=WALK_LENGTH,
                           num_vertices=v)
    torch.cuda.synchronize()
    walk_s = (time.perf_counter() - tw) / iters
    steps = NUM_WALKS * (WALK_LENGTH - 1)

    # one corpus-sized walk call traced: kernels it launches, busy share
    with traced(torch) as prof:
        t1 = time.perf_counter()
        walks.random_walks(csr.offsets, csr.targets, key, num_walks=4096,
                           length=WALK_LENGTH, num_vertices=v)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t1
    _, records = card_records(prof)
    on_card = [(ev.time_range.start, ev.time_range.end)
               for ev in records.values()]
    row.update(
        phase_s=time.perf_counter() - t0,
        walk_trace={"num_walks": 4096, "wall_s": traced_s,
                    "device_events": len(on_card),
                    "device_busy_share": union_us(on_card) / 1e6 / traced_s},
        consumer_run_s=consumer_s, launches=launches, hot_vertex=hot,
        hot_degree=int(deg_np[hot]),
        walks={"num_walks": NUM_WALKS, "steps": WALK_LENGTH - 1,
               "seconds": walk_s, "walk_steps_per_s": steps / walk_s},
        corpus={"batch": 4096, "seq": WALK_LENGTH - 1, "steps": 8,
                "ms_per_batch": corpus_s / 8 * 1e3})
    report["consumers"] = row
    say(json.dumps({"consumers": row}))
    say("phase 3b: gathers, point reads, walks and the corpus check out")
    return {"csr": csr, "inputs": inputs, "launches": launches}


def counted(torch, kernels, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (result, seconds, launches)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def need(launches, names, what):
    require(all(launches[k] > 0 for k in names),
            f"{what}: {', '.join(names)} launched ({launches})")


def same_csr(torch, got, want, what):
    require(got.offsets.is_cuda and got.targets.is_cuda
            and got.offsets.dtype == torch.int64
            and torch.equal(got.offsets, want.offsets)
            and torch.equal(got.targets, want.targets),
            f"{what}: bitwise equal to the text-loaded CSR")


def phase_snapshots(torch, repro_torch, kernels, path22, oracle, consumers,
                    report):
    """``.gvel`` save and load, an edgelist-only snapshot, framed text and
    MTX on the card (phase 3c).  Returns the launch counts per path."""
    from repro_torch.core import codecs
    text_csr = consumers["csr"]
    off_np, tgt_np, _ = oracle
    csr_bytes = 8 * off_np.size + 4 * tgt_np.size
    row, launches = {}, {}
    snap_dir = os.path.join(DATA, "snapshots")
    os.makedirs(snap_dir, exist_ok=True)
    paths = {k: os.path.join(snap_dir, f"rmat22{k}.gvel")
             for k in ("", ".zlib1", ".edges")}

    # 1. save: the edgelist from the stream, the CSR built on the card
    g = repro_torch.open_graph(path22)
    el, row["edgelist_s"], launches["save: edgelist"] = counted(
        torch, kernels, g.edgelist)
    need(launches["save: edgelist"], ("parse_accumulate",), "save: edgelist")
    _, row["save_raw_s"], launches["save: convert_to_csr + write"] = counted(
        torch, kernels, lambda: g.save(paths[""]))
    need(launches["save: convert_to_csr + write"],
         ("degree_histogram", "exclusive_scan"), "save: convert_to_csr")
    _, row["save_zlib1_s"], _ = counted(
        torch, kernels, lambda: g.save(paths[".zlib1"], compress="zlib:1"))
    _, row["save_edges_only_s"], _ = counted(
        torch, kernels, lambda: g.save(paths[".edges"], csr=False))
    del el, g
    row["file_bytes"] = {k: os.path.getsize(p) for k, p in paths.items()}

    # 2. the embedded CSR: twice in the process, the second reported
    loaded = {}
    for key, name in (("", "raw"), (".zlib1", "zlib1")):
        for turn in range(2):
            csr, sec, lc = counted(
                torch, kernels,
                lambda: repro_torch.open_graph(paths[key]).csr())
            require(sum(lc.values()) == 0,
                    f"snapshot {name}: the embedded CSR runs no kernel")
        same_csr(torch, csr, text_csr, f"snapshot {name}")
        check_csr(csr, oracle, False, f"snapshot {name}")
        loaded[name] = csr
        row[f"load_{name}_s"] = sec
        row[f"load_{name}_GBps"] = csr_bytes / sec / 1e9
    del loaded["raw"]
    # the raw load's floor on the host: the CSR sections read from the page
    # cache into one pinned chunk, with no copy to the card
    from repro_torch.core import snapshot
    cells = snapshot.read_snapshot(paths[""], eager=False)._sections
    buf = memoryview(torch.empty(snapshot.CHUNK_BYTES, dtype=torch.uint8,
                                 pin_memory=True).numpy())
    t0 = time.perf_counter()
    with open(paths[""], "rb") as f:
        for sid in (snapshot.SEC_CSR_OFFSETS, snapshot.SEC_CSR_INDICES):
            f.seek(cells[sid].offset)
            left = cells[sid].nbytes
            while left:
                left -= f.readinto(buf[:min(left, len(buf))])
    row["read_csr_sections_alone_s"] = time.perf_counter() - t0
    # the zlib:1 load's floor on the host: its CSR sections inflated by one
    # thread (the reference's decompress_frames) and by the decode pool
    cells = snapshot.read_snapshot(paths[".zlib1"], eager=False)._sections
    csr_ids = (snapshot.SEC_CSR_OFFSETS, snapshot.SEC_CSR_INDICES)
    t0 = time.perf_counter()
    for sid in csr_ids:
        c = cells[sid]
        codecs.decompress_frames(c._payload(), c.raw_nbytes, c.codec)
    row["inflate_csr_one_thread_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for sid in csr_ids:
        cells[sid].tensor(torch.device("cpu"))
    row["inflate_csr_pool_s"] = time.perf_counter() - t0
    row["host_cpus"] = {"cpu_count": os.cpu_count(),
                        "affinity": len(os.sched_getaffinity(0))}
    del cells, buf

    # 3. an edgelist-only snapshot: stream + staged build on the card
    csr, row["load_edges_only_staged_s"], lc = counted(
        torch, kernels,
        lambda: repro_torch.open_graph(paths[".edges"]).csr(method="staged"))
    launches["edgelist-only snapshot"] = lc
    need(lc, ("degree_histogram", "exclusive_scan"), "edgelist-only snapshot")
    same_csr(torch, csr, text_csr, "edgelist-only snapshot")
    del csr

    # 4. framed zlib text at scale 20 through the streaming loader
    p20, s20, d20, _ = make_graph("rmat20.el", FRAMED_SCALE, False, False,
                                  SEED + 30)
    framed = p20 + ".z"
    t0 = time.perf_counter()
    if not os.path.exists(framed):
        codecs.compress_file_framed(p20, framed, codec="zlib", level=1)
    row["framed_setup_s"] = time.perf_counter() - t0
    csr, row["load_framed_s"], lc = counted(
        torch, kernels, lambda: repro_torch.open_graph(framed).csr())
    launches["framed text"] = lc
    need(lc, LOAD_KERNELS, "framed text")
    check_csr(csr, csr_oracle(s20, d20, None, int(max(s20.max(),
                                                      d20.max())) + 1),
              False, "framed zlib text")
    row["framed"] = {"edges": len(s20), "text_bytes": os.path.getsize(p20),
                     "file_bytes": os.path.getsize(framed),
                     "edges_per_s": len(s20) / row["load_framed_s"]}
    del csr, s20, d20

    # 5. a symmetric real MTX file at scale 18, weighted
    mtx_path = os.path.join(DATA, "rmat18s.mtx")
    sm, dm, _v = rmat_edges(MTX_SCALE, EDGE_FACTOR, SEED + 40)
    wint = np.random.default_rng(SEED + 41).integers(0, 10**6, len(sm))
    wm = wint.astype(np.float32) / np.float32(10**4)
    vm = 1 << MTX_SCALE
    if not os.path.exists(mtx_path):
        write_edgelist(mtx_path, sm, dm, wint, header=(
            f"%%MatrixMarket matrix coordinate real symmetric\n"
            f"% RMAT scale {MTX_SCALE}, seed {SEED + 40}\n"
            f"{vm} {vm} {len(sm)}\n").encode())
    keep = sm != dm
    want = csr_oracle(np.concatenate([sm, dm[keep]]),
                      np.concatenate([dm, sm[keep]]),
                      np.concatenate([wm, wm[keep]]), vm)
    csr, row["load_mtx_s"], lc = counted(
        torch, kernels, lambda: repro_torch.open_graph(mtx_path).csr())
    launches["mtx (convert_to_csr)"] = lc
    need(lc, LOAD_KERNELS, "mtx")
    require(csr.weights is not None and csr.num_vertices == vm,
            "mtx: weighted, |V| from the size line")
    check_csr(csr, want, True, "symmetric real mtx")
    row["mtx"] = {"entries": len(sm), "edges": int(want[1].size),
                  "self_loops": int((~keep).sum()),
                  "edges_per_s": want[1].size / row["load_mtx_s"]}
    del csr, want

    # 6. point reads on the zlib:1 snapshot
    zs = repro_torch.open_graph(paths[".zlib1"])
    v = off_np.size - 1
    deg_np = np.diff(off_np)
    hot = int(deg_np.argmax())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u in (0, 1, hot, int(np.argmin(deg_np)), v // 2, v - 1):
        lo, hi = int(off_np[u]), int(off_np[u + 1])
        got = zs.neighbors(u)
        require(got.is_cuda and np.array_equal(got.cpu().numpy(),
                                               tgt_np[lo:hi]),
                f"snapshot point reads: neighbors({u})")
        require(zs.degree(u) == hi - lo, f"snapshot point reads: degree({u})")
    for lo, hi in ((max(hot - 2, 0), min(hot + 3, v)), (v - 100, v)):
        part = zs.csr(rows=(lo, hi))
        e_lo = int(off_np[lo])
        require(part.row_start == lo and part.targets.is_cuda
                and np.array_equal(part.offsets.cpu().numpy(),
                                   off_np[lo:hi + 1] - e_lo)
                and np.array_equal(part.targets.cpu().numpy(),
                                   tgt_np[e_lo:int(off_np[hi])]),
                f"snapshot point reads: csr(rows=({lo}, {hi}))")
    row["point_reads_s"] = time.perf_counter() - t0
    row["frame_cache_stats"] = zs.frame_cache_stats()
    row["hot_vertex"], row["hot_degree"] = hot, int(deg_np[hot])

    # 7. neighbor_gather over the snapshot-loaded CSR
    snap_csr = loaded["zlib1"]
    ids = consumers["inputs"]["uniform"]
    got, _, lc = counted(torch, kernels, lambda: kernels.neighbor_gather(
        ids, snap_csr.offsets, snap_csr.targets, width=GATHER_WIDTH))
    launches["gather on the snapshot CSR"] = lc
    need(lc, ("neighbor_gather",), "gather on the snapshot CSR")
    want = kernels.neighbor_gather(ids, text_csr.offsets, text_csr.targets,
                                   width=GATHER_WIDTH)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "gather on the snapshot CSR equals the text CSR's")
    del got, want, snap_csr, loaded, zs
    row["launches"] = launches
    report["snapshots"] = row
    say(json.dumps({"snapshots": row}))
    say("phase 3c: snapshots, framed text and MTX check out on the card")
    return launches, paths


SERVING_REQUESTS, SERVING_THREADS, NAIVE_SAMPLE = 20000, 4, 20
SERVING_MIX = (("neighbors", 0.60), ("degree", 0.10), ("rows", 0.25),
               ("info", 0.04), ("csr", 0.01))


def serving_requests(paths, v, n, seed):
    """A deterministic mixed stream, built as the reference's query-service
    benchmark builds it: (path, op, a, b) with a vertex or a row span of
    under V/64 rows."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice([k for k, _ in SERVING_MIX], size=n,
                       p=[p for _, p in SERVING_MIX])
    which = rng.integers(0, len(paths), size=n)
    verts = rng.integers(0, v, size=n)
    spans = rng.integers(1, max(2, v // 64), size=n)
    reqs = []
    for k, w, u, sp in zip(kinds, which, verts, spans):
        if k in ("neighbors", "degree"):
            reqs.append((paths[w], str(k), int(u), 0))
        elif k == "rows":
            reqs.append((paths[w], "rows", int(u), min(v, int(u) + int(sp))))
        else:
            reqs.append((paths[w], str(k), 0, 0))
    return reqs


def serve(cache, req):
    path, op, a, b = req
    if op in ("neighbors", "degree"):
        return cache.query(path, op, vertex=a)
    if op == "rows":
        return cache.query(path, "rows", rows=(a, b))
    return cache.query(path, op)


def naive_answer(repro_torch, req):
    """The answer without the serving layer: open, load the full CSR,
    slice."""
    path, op, a, b = req
    csr = repro_torch.open_graph(path).csr()
    if op == "neighbors":
        return csr.targets[csr.offsets[a]:csr.offsets[a + 1]]
    if op == "degree":
        return int(csr.offsets[a + 1] - csr.offsets[a])
    if op == "rows":
        from repro_torch.core import slice_csr
        return slice_csr(csr, a, b)
    return csr


class OnCard:
    """A numpy CSR oracle, and the same arrays on the card (where answers
    are compared)."""

    def __init__(self, torch, oracle):
        self.off, self.tgt = oracle[0], oracle[1]
        self.off_dev = torch.from_numpy(self.off).cuda()
        self.tgt_dev = torch.from_numpy(self.tgt).cuda()
        self.checked = set()            # full CSRs already compared


def check_answer(torch, ans, req, ref, text_path, what):
    """One answer bitwise against the oracle."""
    path, op, a, b = req
    off = ref.off
    if op == "neighbors":
        require(ans.is_cuda and torch.equal(
            ans, ref.tgt_dev[int(off[a]):int(off[a + 1])]),
            f"{what}: neighbors({a}) of {path}")
    elif op == "degree":
        require(ans == int(off[a + 1] - off[a]),
                f"{what}: degree({a}) of {path}")
    elif op == "rows":
        e_lo, e_hi = int(off[a]), int(off[b])
        require(ans.row_start == a and ans.targets.is_cuda
                and torch.equal(ans.offsets, ref.off_dev[a:b + 1] - e_lo)
                and torch.equal(ans.targets, ref.tgt_dev[e_lo:e_hi]),
                f"{what}: rows [{a}, {b}) of {path}")
    elif op == "info":
        require(ans.format == "text" if path == text_path else (
            ans.num_vertices == off.size - 1
            and ans.num_edges == ref.tgt.size), f"{what}: info of {path}")
    elif id(ans) not in ref.checked:
        require(ans.offsets.is_cuda and torch.equal(ans.offsets, ref.off_dev)
                and torch.equal(ans.targets, ref.tgt_dev),
                f"{what}: csr of {path}")
        ref.checked.add(id(ans))


def percentiles(xs):
    a = np.sort(np.asarray(xs)) * 1e3
    return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean()), "max_ms": float(a.max())}


def phase_serving(torch, repro_torch, kernels, path22, oracle, snap_paths,
                  swap_graph, report):
    """The query-serving cache and the fault plan on the card (phase 3d).
    Returns the launch counts of the cold ``csr`` query."""
    import threading
    from repro_torch.core import faults, snapshot
    from repro_torch.core.cache import SourceCache
    from repro_torch.core.faults import (CorruptGraphError, FaultPlan,
                                         FaultSpec, StageTimeout,
                                         fault_plan)
    t_phase = time.perf_counter()
    off_np = oracle[0]
    ref = OnCard(torch, oracle)
    v = off_np.size - 1
    raw, z1 = snap_paths[""], snap_paths[".zlib1"]
    files = [raw, z1, path22]
    row, launches = {"files": {"raw": os.path.getsize(raw),
                               "zlib1": os.path.getsize(z1),
                               "text": os.path.getsize(path22)}}, {}

    # 1. the cold csr query of the text file, its launches counted
    cache = SourceCache(capacity=4)
    first, row["cold_csr_text_s"], lc = counted(
        torch, kernels, lambda: cache.query(path22, "csr"))
    launches["serving: cold csr query (text)"] = lc
    need(lc, LOAD_KERNELS, "serving: cold csr query")
    check_csr(first, oracle, False, "serving: cold csr query")
    # eight threads ask one fresh cache for one cold CSR at once
    cold = SourceCache(capacity=4)
    gate = threading.Barrier(8)
    got = [None] * 8

    def ask(i):
        gate.wait(60)
        got[i] = cold.query(path22, "csr")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    row["cold_csr_8_threads_s"] = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads)
            and all(g is got[0] for g in got),
            "serving: 8 threads share one cold CSR")
    require(cold.stats()["misses"] == 1, f"serving: 8 threads, misses == 1 "
            f"({cold.stats()['misses']})")
    same_csr(torch, got[0], first, "serving: 8 threads' cold CSR")
    del cold, got, threads

    # 2. the mixed stream on 4 threads, timed; answers checked after it
    reqs = serving_requests(files, v, SERVING_REQUESTS, SEED + 50)
    answers = [None] * len(reqs)
    lat = [0.0] * len(reqs)
    failures = []

    def worker(k):
        try:
            for i in range(k, len(reqs), SERVING_THREADS):
                t1 = time.perf_counter()
                answers[i] = serve(cache, reqs[i])
                lat[i] = time.perf_counter() - t1
        except Exception as exc:        # reported by the main thread
            failures.append(repr(exc))
    before = cache.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(SERVING_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(not failures and not any(t.is_alive() for t in threads),
            f"serving: the stream ran ({failures[:3]})")
    st = cache.stats()
    kind = {raw: "raw", z1: "zlib1", path22: "text"}
    by_op, by_op_file = {}, {}
    for req, x in zip(reqs, lat):
        by_op.setdefault(req[1], []).append(x)
        by_op_file.setdefault(f"{req[1]} {kind[req[0]]}", []).append(x)
    row["stream"] = {
        "requests": len(reqs), "threads": SERVING_THREADS,
        "mix": dict(SERVING_MIX), "wall_s": wall,
        "requests_per_s": len(reqs) / wall,
        "by_op": {k: percentiles(x) for k, x in sorted(by_op.items())},
        "by_op_file": {k: percentiles(x)
                       for k, x in sorted(by_op_file.items())},
        "hits": st["hits"] - before["hits"],
        "misses": st["misses"] - before["misses"],
        "frame_cache": st["frame_cache"]}
    t0 = time.perf_counter()
    for i, (req, ans) in enumerate(zip(reqs, answers)):
        check_answer(torch, ans, req, ref, path22, f"serving request {i}")
    row["stream"]["check_s"] = time.perf_counter() - t0
    require(row["stream"]["misses"] == 2,
            f"serving: the stream opened the two snapshots once each "
            f"({row['stream']['misses']})")
    del answers

    # point and row requests answered without the serving layer, on a
    # sample
    sliced = [i for i, r in enumerate(reqs)
              if r[1] in ("neighbors", "degree", "rows")]
    pick = np.random.default_rng(SEED + 51).choice(
        sliced, NAIVE_SAMPLE, replace=False)
    naive = []
    for i in pick:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ans = naive_answer(repro_torch, reqs[i])
        torch.cuda.synchronize()
        naive.append(time.perf_counter() - t1)
        check_answer(torch, ans, reqs[i], ref, path22,
                     f"naive request {i}")
        del ans
    row["naive"] = {"sample": NAIVE_SAMPLE,
                    "ops": [reqs[i][1] + " " + kind[reqs[i][0]]
                            for i in pick],
                    **percentiles(naive),
                    "served_mean_ms_same_requests": float(
                        np.mean([lat[i] for i in pick]) * 1e3)}
    del lat
    say(json.dumps({"serving_stream": {
        k: x for k, x in row["stream"].items() if k != "by_op_file"},
        "naive": row["naive"]}))

    # 3. swap: another graph's snapshot replaces the raw one
    new_path, new_oracle = swap_graph
    inv = cache.stats()["invalidations"]
    t0 = time.perf_counter()
    os.replace(new_path, raw)
    nv = new_oracle[0].size - 1
    new_ref = OnCard(torch, new_oracle)
    for u in (0, 1, nv // 2, nv - 1):
        check_answer(torch, cache.query(raw, "neighbors", vertex=u),
                     (raw, "neighbors", u, 0), new_ref, None,
                     "serving: after the swap")
    require(cache.query(raw, "info").num_vertices == nv,
            "serving: info after the swap")
    row["swap_s"] = time.perf_counter() - t0
    require(cache.stats()["invalidations"] - inv == 1,
            "serving: the swap invalidated one entry")

    # 4. faults
    # a. two transient block faults on the text load, retried bitwise
    faults.reset_counters()
    plan = FaultPlan([FaultSpec("block", "oserror", index=3, times=2)])
    t0 = time.perf_counter()
    csr = repro_torch.open_graph(path22, faults=plan).csr()
    torch.cuda.synchronize()
    row["faults"] = {"block_oserror_load_s": time.perf_counter() - t0}
    check_csr(csr, oracle, False, "faults: block:oserror@3*2")
    require(faults.counters()["io_retries"] == 2
            and plan.injected() == {"block:oserror": 2},
            f"faults: two retries ({faults.counters()}, {plan.injected()})")
    del csr
    # b. a bit flipped in a csr_indices frame half-way through the zlib:1
    # section's chunked copy to the card: quarantined, siblings serve,
    # and a swap of the same bytes lifts it
    cache.invalidate(z1)                  # drop the memoized CSR
    n_frames = snapshot.section_frame_counts(z1)["csr_indices"]
    plan = FaultPlan([FaultSpec(
        "frame", "bitflip", index=n_frames // 2,
        path=f"{z1} section {snapshot.SEC_CSR_INDICES}")], seed=SEED)
    t0 = time.perf_counter()
    err = None
    with fault_plan(plan):
        try:
            cache.query(z1, "csr")
        except CorruptGraphError as exc:
            err = exc
    row["faults"]["frame_bitflip_s"] = time.perf_counter() - t0
    require(err is not None and err.section == "csr_indices"
            and err.path == z1 and plan.injected() == {"frame:bitflip": 1},
            f"faults: frame:bitflip gives CorruptGraphError(csr_indices) "
            f"({err!r}, {plan.injected()})")
    torch.cuda.synchronize()
    u = int(np.argmax(np.diff(off_np)))
    require(cache.query(z1, "degree", vertex=u)
            == int(off_np[u + 1] - off_np[u])
            and cache.query(z1, "info").num_vertices == v,
            "faults: degree and info serve under the quarantine")
    err = None
    try:
        cache.query(z1, "neighbors", vertex=u)
    except CorruptGraphError as exc:
        err = exc
    require(err is not None and "quarantined" in str(err),
            "faults: neighbors is quarantined")
    t0 = time.perf_counter()
    shutil.copyfile(z1, z1 + ".swap")
    os.replace(z1 + ".swap", z1)
    csr = cache.query(z1, "csr")
    row["faults"]["swap_back_s"] = time.perf_counter() - t0
    check_csr(csr, oracle, False, "faults: served after the swap back")
    fs = cache.stats()["faults"]
    require(fs["recovered"] >= 1 and not fs["quarantined"],
            f"faults: the swap lifted the quarantine ({fs})")
    row["faults"]["cache"] = fs
    del csr
    # c. a stalled reader under a lowered watchdog
    budget, saved = 1.0, faults.WATCHDOG_S
    faults.WATCHDOG_S = budget
    plan = FaultPlan([FaultSpec("block", "stall", index=0, delay_s=5.0)])
    err = None
    t0 = time.perf_counter()
    try:
        repro_torch.open_graph(path22, faults=plan).csr()
    except StageTimeout as exc:
        err = exc
    finally:
        faults.WATCHDOG_S = saved
    dt = time.perf_counter() - t0
    row["faults"]["stall"] = {"budget_s": budget, "raised_after_s": dt,
                              "message": str(err)}
    require(err is not None and "byte span [0, " in str(err)
            and dt < budget + 1.0,
            f"faults: StageTimeout within budget + 1 s ({dt:.2f}s, {err!r})")
    csr = repro_torch.open_graph(path22).csr()
    check_csr(csr, oracle, False, "faults: the next unfaulted load")
    del csr, first, cache, ref, new_ref
    row["phase_s"] = time.perf_counter() - t_phase
    report["serving"] = row
    say(json.dumps({"serving": {k: x for k, x in row.items()
                                if k not in ("stream", "naive")}}))
    say("phase 3d: the serving cache and the fault plan check out on the "
        "card")
    return launches


# ---------------------------------------------------------------------------
# phase 3e: the sharded load and the tuner
# ---------------------------------------------------------------------------

def rank_rows(torch, csr, what):
    """``(offsets, valid targets, num_vertices, row_start)`` of a rank's
    sharded CSR, on the host, after checking it is on the card with int32
    offsets and -1 past the valid prefix of its receive-sized targets."""
    n = int(csr.offsets[-1])
    require(csr.offsets.is_cuda and csr.targets.is_cuda
            and csr.offsets.dtype == torch.int32
            and bool((csr.targets[n:] == -1).all()),
            f"{what}: on the card, int32 offsets, -1 past the valid prefix")
    return (csr.offsets.cpu().numpy(), csr.targets[:n].cpu().numpy(),
            csr.num_vertices, csr.row_start)


def check_rows(rows_of_k, oracle, k, d, what):
    """Rank ``k``'s rows of a ``d``-way sharded CSR (:func:`rank_rows`)
    against the oracle, bitwise, in the reference's layout: ``ceil(V/d)``
    rows from ``k * rows``."""
    off, tgt, v_got, row_start = rows_of_k
    off_o, tgt_o, _ = oracle
    v = off_o.size - 1
    rows = max(-(-v // d), 1)
    lo, hi = min(k * rows, v), min((k + 1) * rows, v)
    require(off.size == rows + 1 and row_start == k * rows and v_got == v,
            f"{what}: rank {k} holds rows [{k * rows}, {(k + 1) * rows})")
    e_lo, e_hi = int(off_o[lo]), int(off_o[hi])
    require(np.array_equal(off[:hi - lo + 1], off_o[lo:hi + 1] - e_lo)
            and (off[hi - lo:] == e_hi - e_lo).all(), f"{what}: offsets")
    require(np.array_equal(tgt, tgt_o[e_lo:e_hi]), f"{what}: targets")


@contextlib.contextmanager
def spy_on(module, name, record):
    """For the block, ``module.name(*args, **kw)`` calls ``record(real,
    args, kw)``, which calls the real function and notes what it wants."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        return record(real, args, kw)
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


SHARD_STAGES = ("stream_shards", "bucket_histogram", "bucket_by_owner",
                "exchange_by_owner", "build_local_csr")


def staged_load(torch, distributed, load):
    """``load()`` with each stage of the sharded load timed (seconds per
    stage, the card synchronized around each; ``exchange_by_owner``
    includes ``bucket_by_owner``, and ``exchange_collectives_s`` is the
    rest of it: the size check's gather and the ``all_to_all`` s)."""
    times = {}
    with contextlib.ExitStack() as stack:
        for name in SHARD_STAGES:
            def record(real, args, kw, name=name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*args, **kw)
                torch.cuda.synchronize()
                times[name + "_s"] = time.perf_counter() - t0
                return out
            stack.enter_context(spy_on(distributed, name, record))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load()
        torch.cuda.synchronize()
        times["load_s"] = time.perf_counter() - t0
    times["exchange_collectives_s"] = (times["exchange_by_owner_s"]
                                       - times["bucket_by_owner_s"])
    return times


def sharded_caps(seen):
    """A ``record`` for :func:`spy_on` over ``distributed.load_csr_sharded``:
    keeps the ``send_cap`` and ``edge_limit`` the stream measured."""
    def record(real, args, kw):
        seen.update(send_cap=kw["send_cap"], edge_limit=kw["edge_limit"])
        return real(*args, **kw)
    return record


def shard_rank(cfg_path) -> int:
    """One rank of a world of :func:`run_world`: the scale-22 text loaded
    twice through ``csr_sharded``, the second timed, launches counted for
    each, and once more with its stages timed; the rows written for the
    parent to check; then ``shard-reexec`` on the same world, bitwise
    against the clean rows.  Rank k runs on card ``k % cards``."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import distributed, faults
    from repro_torch.core.faults import FaultPlan, FaultSpec
    from repro_torch.scripts import local_world
    with open(cfg_path) as f:
        cfg = json.load(f)
    torch.cuda.set_device(int(os.environ["RANK"])
                          % torch.cuda.device_count())
    mesh, rank, world = local_world.join(cfg["backend"], "cuda")
    row = {"rank": rank, "world": world}
    try:
        caps = {}
        with spy_on(distributed, "load_csr_sharded", sharded_caps(caps)):
            for turn in (1, 2):
                csr, sec, lc = counted(torch, kernels, lambda: repro_torch.
                                       open_graph(cfg["path"]).csr_sharded(
                                           mesh))
                need(lc, LOAD_KERNELS, f"d={world} rank {rank} load {turn}")
                row[f"load{turn}_s"], row[f"launches{turn}"] = sec, lc
        row.update(caps)
        row["stages"] = staged_load(torch, distributed, lambda: repro_torch.
                                    open_graph(cfg["path"]).csr_sharded(mesh))
        off, tgt, row["num_vertices"], row["row_start"] = rank_rows(
            torch, csr, f"d={world} rank {rank}")
        np.save(os.path.join(cfg["out"], f"offsets{rank}.npy"), off)
        np.save(os.path.join(cfg["out"], f"targets{rank}.npy"), tgt)
        row["receive_slots"] = csr.targets.numel()
        del off, tgt
        faults.reset_counters()
        plan = FaultPlan([FaultSpec("block", "oserror", index=0, times=3)],
                         seed=SEED)
        faulty, row["reexec_s"], _ = counted(
            torch, kernels, lambda: repro_torch.open_graph(
                cfg["path"], faults=plan).csr_sharded(mesh))
        require(torch.equal(faulty.offsets, csr.offsets)
                and torch.equal(faulty.targets, csr.targets),
                f"shard-reexec rank {rank}: bitwise equal to the clean load")
        row["reexec_counters"] = faults.counters()
    finally:
        local_world.leave()
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    return 0


def run_world(path22, oracle, world, backend):
    """A world of ``world`` ranks of this script (:func:`shard_rank`) over
    ``backend``, each rank's rows held bitwise against the oracle here.
    Returns ``(row, launches)``: the world's wall time and every rank's
    report, and the launches of the ranks' timed loads, summed."""
    from repro_torch.scripts import local_world
    out = os.path.join(OUT, f"world{world}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg = os.path.join(out, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"path": path22, "out": out, "backend": backend}, f)
    t0 = time.perf_counter()
    runs = local_world.spawn([sys.executable, os.path.abspath(__file__),
                              "--shard-rank", cfg], world, timeout=420,
                             workdir=out)
    row = {"world_s": time.perf_counter() - t0, "backend": backend,
           "ranks": []}
    what = f"d={world} over {backend}"
    for k, run in enumerate(runs):
        require(run.returncode == 0, f"{what}: rank {k} exited "
                f"{run.returncode}:\n{run.stdout[-3000:]}"
                f"{run.stderr[-3000:]}")
        with open(os.path.join(out, f"rank{k}.json")) as f:
            rank_row = json.load(f)
        check_rows((np.load(os.path.join(out, f"offsets{k}.npy")),
                    np.load(os.path.join(out, f"targets{k}.npy")),
                    rank_row["num_vertices"], rank_row["row_start"]),
                   oracle, k, world, f"{what}: rank {k}")
        row["ranks"].append(rank_row)
    retries = [r["reexec_counters"]["shard_retries"] for r in row["ranks"]]
    require(sorted(retries) == [0] * (world - 1) + [1],
            f"{what}: shard-reexec re-executed one shard once ({retries})")
    shutil.rmtree(out, ignore_errors=True)
    launches = {name: sum(r["launches2"][name] for r in row["ranks"])
                for name in row["ranks"][0]["launches2"]}
    return row, launches


CARDS_SECTIONS = ("load", "dp", "tp", "fsdp", "launch")


def sharded_across_cards(torch, cards: int, only=CARDS_SECTIONS) -> int:
    """``--cards N``: the sharded load as it is deployed, one rank a card
    over NCCL, in worlds of 1 and of N ranks on the scale-22 text, each
    rank's rows bitwise against the oracle; then data-parallel training
    across the N cards (:func:`train_dp_across_cards`), tensor-parallel
    decode and training, FSDP training and the local step at
    ``fsdp=True`` (:func:`launch_across_cards`); ``only`` picks among
    ``CARDS_SECTIONS``.  Prints a JSON line for each and writes
    ``build/repro_torch/chip_smoke_cards.json``."""
    from repro_torch.core import env
    from repro_torch.kernels import _lib
    require(torch.cuda.device_count() >= cards,
            f"--cards {cards}: {torch.cuda.device_count()} card(s) here")
    _lib.lib()                        # built once, before the ranks start
    report = {"platform": env.platform_profile(), "sections": list(only)}
    if {"load", "dp", "tp", "fsdp"} & set(only):
        p22, s22, d22, _ = make_graph("rmat22.el", MAIN_SCALE, False, False,
                                      SEED)
    if "load" in only:
        oracle = csr_oracle(s22, d22, None,
                            int(max(s22.max(), d22.max())) + 1)
        del s22, d22
        for world in (1, cards):
            report[f"d{world}"], report[f"d{world}_launches"] = run_world(
                p22, oracle, world, "nccl")
            say(json.dumps({f"nccl_d{world}": report[f"d{world}"]}))
        del oracle
    if "dp" in only:
        report["train_dp"] = train_dp_across_cards(torch, cards, p22)
        say(json.dumps({f"train_dp_nccl_d{cards}": report["train_dp"]}))
    if "tp" in only:
        report["tp"] = tp_across_cards(torch, cards, p22)
        say(json.dumps({f"tp_nccl_{cards}": report["tp"]}))
    if "fsdp" in only:
        report["fsdp"] = fsdp_across_cards(torch, cards, p22)
        say(json.dumps({f"fsdp_nccl_{cards}": report["fsdp"]}))
    if "launch" in only:
        report["launch"] = launch_across_cards(torch, cards)
        say(json.dumps({f"launch_nccl_{cards}": {
            k: v for k, v in report["launch"].items() if k != "ranks"}
            | {"rank0": report["launch"]["ranks"][0]}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    report["nvidia_smi"] = smi
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke_cards.json"), "w") as f:
        json.dump(report, f, indent=1)
    for line in smi:
        say(line)
    return 0


def phase_sharded(torch, repro_torch, kernels, path22, oracle, report):
    """The sharded load and the tuner on the card (phase 3e).  Returns the
    launch counts per path."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import distributed, tune
    t_phase = time.perf_counter()
    row, launches = {}, {}
    num_edges = int(oracle[0][-1])

    # 1. world size 1 over NCCL, at full width, in this process
    init = os.path.join(OUT, "world1.rendezvous")
    if os.path.exists(init):
        os.remove(init)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        d1 = {}
        with spy_on(distributed, "load_csr_sharded", sharded_caps(d1)):
            for turn in (1, 2):
                csr, sec, lc = counted(torch, kernels, lambda: repro_torch.
                                       open_graph(path22).csr_sharded(mesh))
                need(lc, LOAD_KERNELS, f"d=1 load {turn}")
                check_rows(rank_rows(torch, csr, f"d=1 load {turn}"),
                           oracle, 0, 1, f"d=1 load {turn}")
                d1[f"load{turn}_s"] = sec
                del csr
        d1.update(edges_per_s=num_edges / d1["load2_s"], launches=lc)
        d1["stages"] = staged_load(torch, distributed, lambda: repro_torch.
                                   open_graph(path22).csr_sharded(mesh))
        launches["sharded_d1"] = lc
        p20, s20, d20, _ = make_graph("rmat20.el", FRAMED_SCALE, False,
                                      False, SEED + 30)
        framed = p20 + ".z"
        if not os.path.exists(framed):
            from repro_torch.core import codecs
            codecs.compress_file_framed(p20, framed, codec="zlib", level=1)
        csr, d1["framed20_s"], lc = counted(
            torch, kernels,
            lambda: repro_torch.open_graph(framed).csr_sharded(mesh))
        need(lc, LOAD_KERNELS, "d=1 framed scale-20 load")
        check_rows(rank_rows(torch, csr, "d=1 framed scale-20 load"),
                   csr_oracle(s20, d20, None, int(max(s20.max(), d20.max()))
                              + 1), 0, 1, "d=1 framed scale-20 load")
        launches["sharded_d1 framed20"] = lc
        del csr, s20, d20
        row["d1"] = d1
    finally:
        dist.destroy_process_group()
    say(json.dumps({"sharded_d1": row["d1"]}))

    # 2. a world of 2 ranks over gloo, both on cuda:0: a test of the
    # exchange at d > 1 on the card, not a deployment (NCCL refuses two
    # ranks on one card)
    d2, launches["sharded_d2"] = run_world(path22, oracle, 2, "gloo")
    row["d2"] = d2
    say(json.dumps({"sharded_d2": d2}))

    # 3. the tuner: a fresh profile, one sweep on the card, then a hit
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(OUT, "tune.json")
    tune.clear_cache()
    sweeps = []

    def record(real, args, kw):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = real(*args, **kw)
        torch.cuda.synchronize()
        sweeps.append({"seconds": time.perf_counter() - t0, "rows": rows,
                       "launches": {n: kernels.LAUNCHES[n] - before[n]
                                    for n in before}})
        return rows

    tn = {}
    with spy_on(tune, "run_sweep", record):
        csr, tn["first_tuned_s"], lc = counted(
            torch, kernels, lambda: repro_torch.open_graph(
                path22, tune=True).csr())
        require(len(sweeps) == 1, f"tune: one sweep on a fresh profile "
                f"({len(sweeps)})")
        check_csr(csr, oracle, False, "tuned load (with its sweep)")
        del csr
        need(sweeps[0]["launches"], ("parse_accumulate",), "tune sweep")
        launches["tune_sweep"] = sweeps[0]["launches"]
        for name, kind in (("default_s", False), ("tuned_s", True),
                           ("tuned_again_s", True), ("default_again_s",
                                                     False)):
            csr, tn[name], lc = counted(
                torch, kernels, lambda: repro_torch.open_graph(
                    path22, tune=kind).csr())
            check_csr(csr, oracle, False, f"tune: {name}")
            need(lc, LOAD_KERNELS, f"tune: {name}")
            if kind:
                launches["tuned load"] = lc
            del csr
        require(len(sweeps) == 1, "tune: the profile was read, no sweep")
    with open(tune.cache_path()) as f:
        prof = json.load(f)
    slot = prof["hosts"][tune.host_key(torch.device("cuda", 0))]["unweighted"]
    tn.update(sweep_s=sweeps[0]["seconds"], sweep=sweeps[0]["rows"],
              winner={"beta": slot["beta"],
                      "batch_blocks": slot["batch_blocks"]},
              profile_key=tune.host_key(torch.device("cuda", 0)))
    tune.clear_cache()
    row["tune"] = tn
    say(json.dumps({"tune": tn}))
    row["phase_s"] = time.perf_counter() - t_phase
    row["launches"] = launches
    report["sharded"] = {k: row[k] for k in ("d1", "d2", "phase_s")}
    report["tune"] = tn
    say("phase 3e: the sharded load (d=1 over NCCL, d=2 over gloo) and the "
        "tuner check out on the card")
    return launches


# ---------------------------------------------------------------------------
# phase 3f: walk-LM serving at phi4-mini-3.8b's full width
# ---------------------------------------------------------------------------

SERVE_ARCH = "phi4-mini-3.8b"
SERVE_BATCH, SERVE_MAX_SEQ, SERVE_PROMPT = 8, 128, 8
SERVE_REQUESTS, SERVE_NEW = 32, 32
SERVE_CHECKED = 4         # requests whose every decode step is re-derived
# a decode step's logits against forward_prefill over the same tokens with
# no cache: 8 bf16 ulps of the top logits' binade [4, 8).  Both run the
# same bf16 ops, but cuBLAS picks other kernels for other shapes (M = 8
# against M = the sequence), and an ulp's flip carries through 32 layers:
# a scale-18 run on an H100 differed by up to 0.111 (PERF.md, section 6)
LOGIT_TOL = 0.25


def record_tick_logits(eng, rids):
    """Wrap ``eng``'s decode step: each tick's logits row (kept on the
    card) of the requests in ``rids``, in order, under their id; the
    prompt's prefill steps are left out.  Returns the record and a counter
    of decode calls."""
    rec, calls, prefilling = {}, [0], [False]
    decode, step_slot = eng.decode, eng._step_slot

    def in_prefill(*args):
        prefilling[0] = True
        try:
            return step_slot(*args)
        finally:
            prefilling[0] = False

    def recorded(*args):
        calls[0] += 1
        nxt, logits, caches = decode(*args)
        if not prefilling[0]:
            for s, req in enumerate(eng.slots):
                if req is not None and req.rid in rids:
                    rec.setdefault(req.rid, []).append(logits[s].clone())
        return nxt, logits, caches

    eng._step_slot, eng.decode = in_prefill, recorded
    return rec, calls


def cached_decode_check(torch, model, cfg, reqs, rec, what):
    """Every recorded decode step's logits against ``forward_prefill`` on
    the card over the prompt plus the tokens so far, with no cache: the
    largest difference, and the greedy token wherever the prefill's top-2
    margin exceeds ``LOGIT_TOL``."""
    from repro_torch.models import forward_prefill
    worst, total, steps, near = 0.0, 0.0, 0, 0
    with torch.inference_mode():
        for req in reqs:
            seq = list(req.prompt) + req.out
            require(len(rec[req.rid]) == len(req.out),
                    f"{what}: every decode step of request {req.rid} kept")
            for j, got in enumerate(rec[req.rid]):
                n = len(req.prompt) + j
                toks = torch.tensor([seq[:n]], dtype=torch.int32,
                                    device=got.device)
                want, _ = forward_prefill(model, {"tokens": toks}, cfg,
                                          SERVE_MAX_SEQ)
                want = want[0].float()
                err = (got.float() - want).abs()
                worst = max(worst, float(err.max()))
                total += float(err.mean())
                top2 = torch.topk(want, 2).values
                if float(top2[0] - top2[1]) > LOGIT_TOL:
                    require(int(torch.argmax(want)) == req.out[j],
                            f"{what}: request {req.rid} step {j}: greedy "
                            f"token agrees with the uncached prefill")
                else:
                    near += 1
                steps += 1
    require(worst <= LOGIT_TOL, f"{what}: decode logits within {LOGIT_TOL} "
            f"of the uncached prefill's (max {worst})")
    return {"max_abs_err": worst, "mean_abs_err": total / max(steps, 1),
            "steps": steps, "steps_within_margin": near}


def free_card(torch):
    """Drop a served model's memory: the engine and the wrapped decode step
    that records its ticks refer to each other, so the model goes only
    when the cycle collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def check_prompts(torch, rt, reqs, path_of, vocab, what):
    """Each request's prompt is the port's random walk on the card for
    ``(seed, rid)`` over its graph (``path_of[rid]``), mod ``vocab``, and
    every step of the walk is an edge or a dead-end self-loop."""
    from repro_torch.data import prng
    from repro_torch.data.walks import random_walks
    key = prng.key(SEED, device=torch.device("cuda", 0))
    num = max(r.rid for r in reqs) + 1
    for path in sorted(set(path_of.values())):
        csr = rt.cache.get(path).csr()
        walks = random_walks(csr.offsets, csr.targets, key, num_walks=num,
                             length=len(reqs[0].prompt),
                             num_vertices=csr.num_vertices)
        mine = [r for r in reqs if path_of[r.rid] == path]
        rows = walks[[r.rid for r in mine]]
        want = (rows % vocab).cpu().numpy()
        require(all(np.array_equal(r.prompt, w) for r, w in zip(mine, want)),
                f"{what}: prompts are the walks on {os.path.basename(path)}")
        require(walk_steps_valid(torch, rows, csr.offsets, csr.targets),
                f"{what}: every prompt step is an edge of "
                f"{os.path.basename(path)} or a dead-end self-loop")
        del csr, walks


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches
               for t in c.values())


def decode_step(torch, model, cfg, caches, max_seq, weight_bytes):
    """One batch-8 decode step over ``caches``: CUDA-event times call by
    call (mean, p50, min, max, std of 30 after 5), its bound (the bf16
    weights and every cache tensor read once over 3.35 TB/s), and from the
    profiler the launches and device ms a step and the kernels that take
    the most device time."""
    from repro_torch.serve.step import make_decode_step
    dev = torch.device("cuda", 0)
    decode = make_decode_step(cfg, max_seq)
    batch = caches[0][next(iter(caches[0]))].shape[0]
    step_batch = {"token": torch.arange(batch, dtype=torch.int32,
                                        device=dev),
                  "pos": torch.full((batch,), max_seq // 2,
                                    dtype=torch.int32, device=dev)}

    def step():
        decode(model, caches, step_batch)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(30):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    mean = sum(times) / len(times)
    row = {"decode_step_ms": {
        "mean": mean, "min": times[0], "p50": times[len(times) // 2],
        "max": times[-1],
        "std": (sum((t - mean) ** 2 for t in times) / len(times)) ** 0.5,
        "calls": len(times)}}
    row["cache_bytes"] = cache_bytes(caches)
    row["decode_step_bound_ms"] = bound_ms(weight_bytes + row["cache_bytes"])

    with traced(torch) as prof:
        for _ in range(5):
            step()
    launches, records = card_records(prof)
    kernel_launches = [e for e in launches if "LaunchKernel" in e.name]
    kept = [records[e.id] for e in launches if e.id in records]
    by_kernel = {}
    for r in kept:
        n, us = by_kernel.get(r.name, (0, 0.0))
        by_kernel[r.name] = (n + 1, us + r.time_range.end - r.time_range.start)
    row["profile_step"] = {
        "launches_per_step": len(launches) / 5,
        "kernel_launches_per_step": len(kernel_launches) / 5,
        "device_ms_per_step": sum(r.time_range.end - r.time_range.start
                                  for r in kept) / 5 / 1e3,
        "records_lost": len(launches) - len(kept),
        "top": [{"name": name[:70], "calls_per_step": n / 5,
                 "device_ms_per_step": us / 5 / 1e3}
                for name, (n, us) in sorted(by_kernel.items(),
                                            key=lambda kv: -kv[1][1])[:10]]}
    return row


def phase_serve_lm(torch, repro_torch, kernels, snap_path, text_path,
                   report):
    """Walk-LM serving at phi4-mini-3.8b's full width on the card (phase
    3f).  Returns the launch counts of the text graph's first request."""
    from repro_torch.configs import get_config
    from repro_torch.core.cache import SourceCache
    from repro_torch.models import init_params
    from repro_torch.serve.runtime import ServeRuntime
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row = {"arch": SERVE_ARCH, "params": cfg.param_count()}

    # 1. the model: bf16 matrices and embedding, f32 norms, drawn on the card
    t0 = time.perf_counter()
    model = init_params(cfg, SEED)
    torch.cuda.synchronize()
    row["init_s"] = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    require(sum(p.numel() for p in model.parameters())
            == cfg.param_count() + cfg.d_model,       # + the final norm
            "serve_lm: the model has phi4-mini's parameters")
    require(all(p.is_cuda for p in model.parameters())
            and model.embed.dtype == torch.bfloat16,
            "serve_lm: bf16 weights on the card")
    row["weight_bytes"] = weight_bytes

    # 2. argmax takes the first of tied maxima at the served vocab size
    g = torch.Generator(device=dev).manual_seed(SEED)
    logits = torch.randn((SERVE_BATCH, cfg.vocab_size), generator=g,
                         device=dev).to(torch.bfloat16)
    pairs = torch.stack([torch.randperm(cfg.vocab_size, generator=g,
                                        device=dev)[:2].sort().values
                         for _ in range(SERVE_BATCH)])
    logits.scatter_(1, pairs, 9.0)
    require(torch.equal(torch.argmax(logits, dim=-1), pairs[:, 0]),
            "serve_lm: argmax returns the first of tied maxima")
    del logits

    # 3. 32 requests alternating between the raw snapshot and the text; the
    # text's first request loads the graph cold, its launches counted
    files = [snap_path, text_path]
    rt = ServeRuntime(cfg, model, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
                      cache=SourceCache(capacity=4), prompt_len=SERVE_PROMPT,
                      seed=SEED)
    rec, calls = record_tick_logits(rt.engine, set(range(SERVE_CHECKED)))
    t0 = time.perf_counter()
    reqs = [rt.submit(files[0], max_new=SERVE_NEW)]
    row["cold_snapshot_request_s"] = time.perf_counter() - t0
    first_text, row["cold_text_request_s"], lc = counted(
        torch, kernels, lambda: rt.submit(files[1], max_new=SERVE_NEW))
    need(lc, LOAD_KERNELS, "serve_lm: the text graph's first request")
    reqs.append(first_text)
    for i in range(2, SERVE_REQUESTS):
        reqs.append(rt.submit(files[i % 2], max_new=SERVE_NEW))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = rt.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    require(all(r.done and len(r.out) == SERVE_NEW for r in reqs),
            f"serve_lm: every request completes with {SERVE_NEW} tokens")
    st = rt.stats()
    row.update(drain_s=drain_s, ticks=ticks, tokens=tokens,
               decode_calls=calls[0], tokens_per_s=tokens / drain_s,
               runtime_tokens_per_s=st["tokens_per_s"],
               occupancy=st["occupancy"],
               cache_misses=st["cache"]["misses"])

    # 4. each prompt is the port's random walk on the card for (seed, rid),
    # and every step of the walk is an edge or a dead-end self-loop
    check_prompts(torch, rt, reqs, {r.rid: files[r.rid % 2] for r in reqs},
                  cfg.vocab_size, "serve_lm")

    # 5. cached decode against the uncached prefill, with the bf16 reduced-
    # precision reduction of cuBLAS on (the default) and off
    checked = [r for r in reqs if r.rid < SERVE_CHECKED]
    flags = {"allow_bf16_reduced_precision_reduction": torch.backends.cuda
             .matmul.allow_bf16_reduced_precision_reduction}
    row["cached_decode"] = {"tol": LOGIT_TOL, "default": cached_decode_check(
        torch, model, cfg, checked, rec, "serve_lm cached decode")}
    row["cached_decode"]["default"].update(flags)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        off = ServeRuntime(cfg, model, batch=SERVE_BATCH,
                           max_seq=SERVE_MAX_SEQ, cache=rt.cache,
                           prompt_len=SERVE_PROMPT, seed=SEED)
        rec_off, _ = record_tick_logits(off.engine, set(range(SERVE_CHECKED)))
        again = [off.submit(files[r.rid % 2], max_new=SERVE_NEW, rid=r.rid)
                 for r in checked]
        off.drain()
        res = cached_decode_check(torch, model, cfg, again, rec_off,
                                  "serve_lm cached decode, reduction off")
        res["tokens_equal_to_default"] = sum(
            a == b for x, y in zip(again, checked)
            for a, b in zip(x.out, y.out))
        row["cached_decode"]["reduced_precision_reduction_off"] = res
        del off, rec_off
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flags["allow_bf16_reduced_precision_reduction"]
    del rec
    say(json.dumps({"serve_lm_cached_decode": row["cached_decode"]}))

    # 6. one decode step at batch 8, timed with CUDA events call by call,
    # and 7. the profiler: launches and device time per decode step ...
    eng = rt.engine
    row.update(decode_step(torch, model, cfg, eng.caches, SERVE_MAX_SEQ,
                           weight_bytes))
    row["kv_cache_bytes"] = row.pop("cache_bytes")
    # ... and the device's busy share over a traced drain of 2 requests
    tr = ServeRuntime(cfg, model, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
                      cache=rt.cache, prompt_len=SERVE_PROMPT, seed=SEED + 1)
    for i in range(2):
        tr.submit(files[i % 2], max_new=8)
    with traced(torch) as prof:
        t0 = time.perf_counter()
        tr.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, records = card_records(prof)
    spans = [(r.time_range.start, r.time_range.end)
             for r in records.values()]
    busy = union_us(spans) / 1e6
    row["traced_drain"] = {"requests": 2, "max_new": 8, "wall_s": wall,
                           "device_busy_s": busy,
                           "device_busy_share": busy / wall,
                           "launches": len(launches),
                           "records_lost": sum(e.id not in records
                                               for e in launches)}
    row["device_busy_share_estimate"] = (
        row["profile_step"]["device_ms_per_step"] * calls[0] / 1e3 / drain_s)
    del tr, prof, records, launches
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rt.close()
    del rt, eng, model
    free_card(torch)
    row["phase_s"] = time.perf_counter() - t_phase
    report["serve_lm"] = row
    say(json.dumps({"serve_lm": row}))
    say("phase 3f: walk-LM serving at phi4-mini-3.8b's full width checks out "
        "on the card")
    return {"serve_lm: the text graph's first request": lc}


# ---------------------------------------------------------------------------
# phase 3g: the remaining serving kinds at full width
# ---------------------------------------------------------------------------

# (arch, layers run, why) -- every width is the published config's; depth
# is cut only where one card cannot hold the model
KIND_ARCHS = (
    ("mixtral-8x22b", 8,
     "56 layers are 282 GB of bf16 weights and one card holds 80 GB; 8 "
     "layers are 40.5 GB"),
    ("llama4-maverick-400b-a17b", 1,
     "one layer's 128 experts are 32.2 GB of bf16 weights; two layers and "
     "the 2.1 GB embedding would leave under 14 GB of the card for the "
     "embedding's f32 draw, the caches and the graphs"),
    ("recurrentgemma-2b", None, None),
    ("falcon-mamba-7b", None, None),
    ("llama-3.2-vision-11b", None, None),
    ("musicgen-large", None, None),
)
KIND_HEADLINE = "mixtral-8x22b"     # 16 requests of 32 tokens, text + .gvel
KIND_REQUESTS, KIND_NEW = 8, 16     # the others, on the raw snapshot
CHECK_SEQS, CHECK_STEPS = 2, 24     # cached decode against the prefill


def route_recorder(torch, moe_mod):
    """Wrap ``moe.route`` while the context is open: each call's expert
    choices per token (``(tokens, top_k)``, sorted) and the router's margin
    at the last choice (the top_k-th probability less the next one)."""
    calls = []
    route = moe_mod.route

    def recorded(p, xg, cfg):
        out = route(p, xg, cfg)
        k = cfg.moe.top_k
        probs = torch.softmax((xg @ p.router).float(), dim=-1)
        top = probs.topk(k + 1, dim=-1).values
        calls.append((torch.stack(out[0], dim=-1).reshape(-1, k).sort(-1)
                      .values, (top[..., k - 1] - top[..., k]).reshape(-1)))
        return out

    @contextlib.contextmanager
    def recording():
        moe_mod.route = recorded
        try:
            yield calls
        finally:
            moe_mod.route = route
    return recording


def kind_decode_check(torch, model, cfg, prompts, extra, what):
    """``CHECK_SEQS`` sequences: ``forward_prefill`` of the prompts, then
    ``CHECK_STEPS`` decode steps fed the cached path's greedy tokens; each
    step's logits against ``forward_prefill`` over the prompt and the
    tokens so far, with no cache.  ``prompts``: ``(B, 8)`` token ids, or
    ``(B, 8, D)`` frames of an embed-stub arch; ``extra``: the prefill's
    other inputs (``image_embeds``).

    MoE: every token's expert choices on both paths are recorded per
    layer.  A router within rounding of a tie may choose another expert
    when the two paths' products round differently (other GEMM shapes), and
    the token's output then moves by O(1); a step whose prefix was routed
    otherwise anywhere is counted, with the router's margin there, and
    left out of the tolerance.  Every other step is held at ``LOGIT_TOL``,
    and its greedy token must equal the prefill's wherever the prefill's
    top-2 margin exceeds it."""
    from repro_torch.models import forward_decode, forward_prefill, moe
    dev = torch.device("cuda", 0)
    b, n0 = prompts.shape[:2]
    frames = prompts.dim() == 3
    recording = route_recorder(torch, moe)
    routed = cfg.moe is not None

    def prefill_input(toks):
        if not frames:
            return {"tokens": torch.cat([prompts] + toks, dim=1), **extra}
        steps = [model.embed[t] for t in toks]
        return {"frames": torch.cat([prompts.to(torch.bfloat16)] + steps,
                                    dim=1), **extra}

    worst, total, steps, near, rerouted, margins = 0.0, 0.0, 0, 0, 0, []
    with torch.inference_mode(), recording() as calls:
        lg, caches = forward_prefill(model, prefill_input([]), cfg,
                                     SERVE_MAX_SEQ)
        table = [c.view(b, n0, -1) for c, _ in calls]      # layer -> choices
        del calls[:]
        toks = []
        for j in range(CHECK_STEPS):
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            toks.append(tok[:, None])
            lg, caches = forward_decode(
                model, {"token": tok, "pos": torch.full(
                    (b,), n0 + j, dtype=torch.int32, device=dev)},
                caches, cfg, SERVE_MAX_SEQ)
            if routed:
                table = [torch.cat([t, c.view(b, 1, -1)], dim=1)
                         for t, (c, _) in zip(table, calls)]
            del calls[:]
            want, _ = forward_prefill(model, prefill_input(toks), cfg,
                                      SERVE_MAX_SEQ)
            if routed:
                moved = [(c.view(b, n0 + j + 1, -1) != t).any(-1)
                         for t, (c, _) in zip(table, calls)]
                if any(bool(m.any()) for m in moved):
                    # the smallest margin among the tokens routed otherwise:
                    # the first flip's; later layers follow from it
                    rerouted += 1
                    margins.append(min(float(mg.view(b, -1)[m].min())
                                       for m, (_, mg) in zip(moved, calls)
                                       if bool(m.any())))
                    del calls[:]
                    continue
            del calls[:]
            nxt = torch.argmax(lg, dim=-1)
            for s in range(b):
                got_s, want_s = lg[s].float(), want[s].float()
                err = (got_s - want_s).abs()
                worst = max(worst, float(err.max()))
                total += float(err.mean())
                top2 = torch.topk(want_s, 2).values
                if float(top2[0] - top2[1]) > LOGIT_TOL:
                    require(int(torch.argmax(want_s)) == int(nxt[s]),
                            f"{what}: sequence {s} step {j}: greedy token "
                            f"agrees with the uncached prefill")
                else:
                    near += 1
                steps += 1
    require(steps > 0, f"{what}: some step compared")
    require(worst <= LOGIT_TOL, f"{what}: decode logits within {LOGIT_TOL} "
            f"of the uncached prefill's (max {worst})")
    return {"tol": LOGIT_TOL, "max_abs_err": worst,
            "mean_abs_err": total / steps, "steps": steps,
            "steps_within_margin": near, "rerouted_steps": rerouted,
            "rerouted_router_margin_max": max(margins) if margins else None}


def serve_kind(torch, kernels, arch, layers, why, files, report):
    """One arch of phase 3g: the model at its published widths (``layers``
    cut, ``why``), served, its cached decode checked, a decode step timed.
    Returns the launch counts of the text graph's first request
    (the headline arch) or None."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.cache import SourceCache
    from repro_torch.models import init_params
    from repro_torch.serve.runtime import ServeRuntime
    t_arch = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    row = {"arch": arch, "layers": cfg.num_layers, "reduced": None}
    if layers is not None:
        row["reduced"] = {"num_layers": [cfg.num_layers, layers],
                          "reason": why}
        cfg = dataclasses.replace(cfg, num_layers=layers)
        row["layers"] = layers
    row["widths"] = {k: getattr(cfg, k) for k in (
        "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
        "vocab_size", "lru_width", "num_image_tokens")}
    if cfg.moe:
        row["widths"]["moe"] = dataclasses.asdict(cfg.moe)
    if cfg.ssm:
        row["widths"]["ssm"] = dataclasses.asdict(cfg.ssm)
    torch.cuda.synchronize()
    row["allocated_before_bytes"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # the model: bf16 matrices, f32 norms (and lam, A_log, D, dt_bias),
    # drawn on the card
    t0 = time.perf_counter()
    model = init_params(cfg, SEED)
    torch.cuda.synchronize()
    row["init_s"] = time.perf_counter() - t0
    row["params"] = sum(p.numel() for p in model.parameters())
    row["param_count"] = cfg.param_count()
    row["weight_bytes"] = weight_bytes = sum(
        p.numel() * p.element_size() for p in model.parameters())
    require(all(p.is_cuda for p in model.parameters())
            and model.embed.dtype == torch.bfloat16,
            f"{arch}: weights on the card, bf16 embedding")

    # serving through ServeRuntime: the headline alternates the raw
    # snapshot and the text, whose first request loads cold and counts the
    # loader's launches; the others serve the raw snapshot
    headline = arch == KIND_HEADLINE
    n_req, new = (SERVE_REQUESTS // 2, SERVE_NEW) if headline else \
        (KIND_REQUESTS, KIND_NEW)
    rt = ServeRuntime(cfg, model, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
                      cache=SourceCache(capacity=4), prompt_len=SERVE_PROMPT,
                      seed=SEED)
    _, calls = record_tick_logits(rt.engine, set())
    reqs, path_of, lc = [], {}, None
    for i in range(n_req):
        path = files[i % 2] if headline else files[0]
        if headline and i == 1:
            req, row["cold_text_request_s"], lc = counted(
                torch, kernels, lambda: rt.submit(path, max_new=new))
            need(lc, LOAD_KERNELS, f"{arch}: the text graph's first request")
        else:
            req = rt.submit(path, max_new=new)
        reqs.append(req)
        path_of[req.rid] = path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ticks = rt.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    require(all(r.done and len(r.out) == new for r in reqs),
            f"{arch}: every request completes with {new} tokens")
    check_prompts(torch, rt, reqs, path_of, cfg.vocab_size, arch)
    tokens = sum(len(r.out) for r in reqs)
    row["serve"] = {"requests": n_req, "max_new": new, "tokens": tokens,
                    "drain_s": drain_s, "tokens_per_s": tokens / drain_s,
                    "decode_calls": calls[0], "ticks": ticks,
                    "files": sorted({os.path.basename(p)
                                     for p in path_of.values()})}

    # cached decode against the uncached prefill, outside the engine (its
    # prefill by decode steps moves a recurrent slot's state); MoE at a
    # capacity that drops nothing, so that no token depends on another
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    ccfg = cfg
    if cfg.moe:
        ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    if cfg.embed_stub:
        prompts = torch.randn((CHECK_SEQS, SERVE_PROMPT, cfg.d_model),
                              generator=g, device=dev)
    else:
        prompts = torch.from_numpy(np.stack(
            [r.prompt for r in reqs[:CHECK_SEQS]])).to(dev)
    extra = {}
    if "xattn" in cfg.layer_pattern:
        extra["image_embeds"] = torch.randn(
            (CHECK_SEQS, cfg.num_image_tokens, cfg.d_model), generator=g,
            device=dev).to(torch.bfloat16)
    row["cached_decode"] = kind_decode_check(torch, model, ccfg, prompts,
                                             extra, f"{arch} cached decode")
    if cfg.moe:
        row["cached_decode"]["capacity_factor"] = ccfg.moe.capacity_factor
    del prompts, extra

    # one batch-8 decode step over the drained engine's caches
    row.update(decode_step(torch, model, cfg, rt.engine.caches,
                           SERVE_MAX_SEQ, weight_bytes))
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rt.close()
    del rt, model
    free_card(torch)
    row["arch_s"] = time.perf_counter() - t_arch
    report.append(row)
    say(json.dumps({"serve_kind": row}))
    return lc


def phase_serve_kinds(torch, kernels, snap_path, text_path, report):
    """The remaining serving kinds at full width on the card (phase 3g):
    MoE, RG-LRU, Mamba, cross-attention and frame inputs, one arch at a
    time, each freed before the next.  Returns the launch counts of the
    headline's text request."""
    t_phase = time.perf_counter()
    rows, lc = [], None
    for arch, layers, why in KIND_ARCHS:
        got = serve_kind(torch, kernels, arch, layers, why,
                         [snap_path, text_path], rows)
        lc = got if got is not None else lc
    report["serve_kinds"] = {"archs": rows,
                             "phase_s": time.perf_counter() - t_phase}
    say("phase 3g: MoE, RG-LRU, Mamba, cross-attention and frame inputs "
        "serve at full width on the card")
    return {f"serve_kinds: {KIND_HEADLINE}'s text request": lc}


# ---------------------------------------------------------------------------
# phase 3h: LM training at phi4-mini-3.8b's full width and depth
# ---------------------------------------------------------------------------

TRAIN_ARCH = "phi4-mini-3.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 8
TRAIN_SKIP = 2           # warm-up steps left out of the step median
FIXED_STEPS = 6          # steps on one fixed walk batch: the loss must fall
# the fixed batch's learning rates, each from a fresh init at warm-up 2:
# the reduced config's 1e-3 (tests/test_train.py) diverges at full width
# (Adam's first steps move every element by ~lr, and the loss climbs back
# past its start within 4 steps: PERF.md, section 5), so it is recorded,
# and the loss is held to fall at 3e-5
FIXED_LRS, FIXED_CHECKED_LR = (1e-3, 3e-5), 3e-5
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 (NVIDIA data sheet)
# bytes a parameter moves in the clip and AdamW at the least: p, m, v read
# and written, the gradient written by the backward pass and read by the
# norm and by the update
OPT_BYTES_PER_PARAM = 36
# the reduced archs held against the CPU, one kind each
TRAIN_KINDS = ("phi4-mini-3.8b", "mixtral-8x22b", "recurrentgemma-2b",
               "falcon-mamba-7b", "llama-3.2-vision-11b", "musicgen-large")
# the card against the CPU on the same weights and batch: each leaf's
# gradient within CARD_GRAD_TOL of its largest magnitude (the CPU tests'
# GRAD_TOL against the reference run op by op), the loss
# (tests/torch_train_ref.py's TRAIN_RTOL), the gradient norm, and the
# params after one AdamW step of lr 1e-3 (Adam's first update is near
# lr * sign(g), so an element whose gradient is near 0 may step the other
# way: up to 2 lr, plus the decay)
CARD_GRAD_TOL = 5e-2
CARD_LOSS_RTOL, CARD_GNORM_RTOL, CARD_PARAM_ATOL = 2e-3, 1e-2, 2.5e-3


def train_bound(cfg, tokens: int, params: int) -> dict:
    """The step's least time on the card: the FLOPs of the forward and
    backward passes, from ``launch.accounting.step_flops`` (the
    reference's analytic accounting: the layers' matrices and the tied
    head, causal attention's scores and values halved; the forward again
    where ``remat="full"`` recomputes it), over the dense bf16 peak, then
    the clip's and AdamW's bytes over the HBM rate; the two run one after
    the other."""
    from repro_torch.launch.accounting import step_flops
    kw = dict(seq=TRAIN_SEQ, batch=tokens // TRAIN_SEQ, kind="train")
    opt_ms = bound_ms(OPT_BYTES_PER_PARAM * params)
    row = {"flops": step_flops(cfg, 1, remat=None, **kw),
           "flops_with_recompute": step_flops(cfg, 1, remat="full", **kw),
           "opt_bytes": OPT_BYTES_PER_PARAM * params, "opt_ms": opt_ms}
    row["flops_ms"] = row["flops"] / BF16_FLOPS_PER_S * 1e3
    row["flops_with_recompute_ms"] = \
        row["flops_with_recompute"] / BF16_FLOPS_PER_S * 1e3
    row["bound_ms"] = row["flops_ms"] + opt_ms
    row["bound_ms_with_recompute"] = row["flops_with_recompute_ms"] + opt_ms
    return row


def spread(xs) -> dict:
    xs = sorted(xs)
    mean = sum(xs) / len(xs)
    return {"p50": xs[len(xs) // 2], "mean": mean, "min": xs[0],
            "max": xs[-1], "std": (sum((x - mean) ** 2 for x in xs)
                                   / len(xs)) ** 0.5, "n": len(xs)}


def traced_step(torch, step_fn, state, batch):
    """One training step under the profiler: launches, device ms (the
    summed records), the device's busy share (their union over the step's
    wall time) and the kernels that take the most device time."""
    with traced(torch) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    launches, records = card_records(prof)
    kept = [records[e.id] for e in launches if e.id in records]
    by_kernel = {}
    for r in kept:
        n, us = by_kernel.get(r.name, (0, 0.0))
        by_kernel[r.name] = (n + 1, us + r.time_range.end - r.time_range.start)
    busy = union_us([(r.time_range.start, r.time_range.end)
                     for r in kept]) / 1e6
    return state, {
        "wall_ms": wall * 1e3, "launches": len(launches),
        "kernel_launches": sum("LaunchKernel" in e.name for e in launches),
        "device_ms": sum(r.time_range.end - r.time_range.start
                         for r in kept) / 1e3,
        "device_busy_share": busy / wall, "records_lost":
        len(launches) - len(kept),
        "top": [{"name": name[:70], "calls": n, "device_ms": us / 1e3}
                for name, (n, us) in sorted(by_kernel.items(),
                                            key=lambda kv: -kv[1][1])[:10]]}


def train_headline(torch, kernels, text_path, row):
    """``repro_torch.launch.train.main`` at phi4-mini-3.8b's full width and
    depth over the scale-22 text (its walks, loaded in the first step with
    the loader's launches counted), then the loss on one fixed walk batch,
    then one traced step.  Returns the loader's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.train import loop as train_loop
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    cfg = get_config(TRAIN_ARCH)
    params = cfg.param_count() + cfg.d_model          # + the final norm
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row.update(arch=TRAIN_ARCH, params=params, layers=cfg.num_layers,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
               remat="full", reduced=None,
               state_bytes_reckoned=16 * params)
    say(f"train_lm: {params} parameters; f32 params, grads and two "
        f"moments take {16 * params / 1e9:.1f} GB")
    captured, loads = {}, []
    real_csr = corpus_mod.WalkCorpus._csr_arrays

    def run(real, args, kw):
        out = real(*args, **kw)
        captured.update(source=args[2], state=out[0], history=out[1])
        return out

    def timed_csr(self):
        cold = self._offsets is None
        t0 = time.perf_counter()
        out = real_csr(self)
        if cold:
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t0)
        return out

    argv = ["--arch", TRAIN_ARCH, "--graph", text_path, "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
            str(TRAIN_STEPS), "--remat", "full", "--seed", str(SEED)]
    corpus_mod.WalkCorpus._csr_arrays = timed_csr
    try:
        with spy_on(train_loop, "run", run):
            rc, secs, lc = counted(torch, kernels,
                                   lambda: launch_train.main(argv))
    finally:
        corpus_mod.WalkCorpus._csr_arrays = real_csr
    require(rc == 0, f"train_lm: launch.train exited {rc}")
    need(lc, LOAD_KERNELS, "train_lm: the text load inside training")
    hist, state = captured["history"], captured["state"]
    losses = [h["loss"] for h in hist]
    require(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)),
            f"train_lm: {TRAIN_STEPS} finite losses ({losses})")
    ln_v = float(np.log(cfg.vocab_size))
    require(abs(losses[0] - ln_v) < 2.0,
            f"train_lm: step 0's loss {losses[0]} near ln V = {ln_v}")
    require(len(loads) == 1, f"train_lm: the graph loaded once ({loads})")
    step_ms = [h["dt"] * 1e3 for h in hist]
    med = spread(step_ms[TRAIN_SKIP:])
    row.update(main_s=secs, losses=losses, ln_vocab=ln_v,
               grad_norms=[h["grad_norm"] for h in hist],
               lrs=[h["lr"] for h in hist], step_ms=step_ms,
               step_ms_after_warmup=med,
               tokens_per_s=tokens / (med["p50"] / 1e3),
               text_load_s=loads[0], launches=lc,
               peak_memory_bytes_main=torch.cuda.max_memory_allocated())
    row.update(bound=train_bound(cfg, tokens, params))
    say(json.dumps({"train_lm_main": {k: row[k] for k in (
        "losses", "step_ms", "tokens_per_s", "text_load_s", "launches",
        "peak_memory_bytes_main")}}))

    # the loss on one fixed walk batch, as tests/test_train.py asks of the
    # reduced config, from a fresh init at each learning rate
    source = captured["source"]
    del state, captured
    free_card(torch)
    batch = source(0)
    toks = batch["tokens"]
    row["fixed_batch"] = {"steps": FIXED_STEPS, "warmup_steps": 2,
                          "checked_lr": FIXED_CHECKED_LR,
                          # a walk at a dead end repeats its vertex
                          "repeated_token_share": float(
                              (toks[:, 1:] == toks[:, :-1]).float().mean())}
    for lr in FIXED_LRS:
        state = init_state(init_params(cfg, SEED, dtype=torch.float32))
        step_fn = make_train_step(cfg, OptimizerConfig(
            lr=lr, warmup_steps=2, decay_steps=100), remat_policy="full")
        fixed = []
        for _ in range(FIXED_STEPS):
            state, m = step_fn(state, batch)
            fixed.append(float(m["loss"]))
        row["fixed_batch"][f"losses_lr_{lr:g}"] = fixed
        if lr != FIXED_CHECKED_LR:
            del state
            free_card(torch)
    require(all(np.isfinite(fixed)) and fixed[-1] < 0.8 * fixed[0],
            f"train_lm: {FIXED_STEPS} steps on one walk batch at lr "
            f"{FIXED_CHECKED_LR:g} lower the loss below 0.8 of its first "
            f"value ({fixed})")
    state, row["profile_step"] = traced_step(torch, step_fn, state, batch)
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del state, batch, source
    return lc


def kind_step(torch, name, reduced_precision):
    """The reduced ``name`` on the card and on the CPU from the same f32
    weights and batch: each leaf's gradient of one loss, then one training
    step's loss, gradient norm and updated params."""
    import copy
    from repro_torch import kernels
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models.blocks import layer_kinds
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    dev = torch.device("cuda", 0)
    cfg = reduced_config(name)
    cpu = init_params(cfg, SEED, device="cpu", dtype=torch.float32)
    card = copy.deepcopy(cpu).to(dev)
    batch = synthetic_batch(cfg, 4, 32, 0, device="cpu")
    step_fn = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=0,
                                                   decay_steps=100))

    def grads(model, b):
        model.zero_grad(set_to_none=True)
        loss_fn(model, b, cfg, "full").backward()
        out = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced_precision
    kernels.reset_launches()
    try:
        g_card = grads(card, {k: v.to(dev) for k, v in batch.items()})
        s_card, m_card = step_fn(init_state(card), batch)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    launches = dict(kernels.LAUNCHES)
    g_cpu = grads(cpu, batch)
    s_cpu, m_cpu = step_fn(init_state(cpu), batch)
    gerr = max(float((g_card[n] - g).abs().max() / g.abs().max())
               for n, g in g_cpu.items())
    loss, want = float(m_card["loss"]), float(m_cpu["loss"])
    gn, gn_want = float(m_card["grad_norm"]), float(m_cpu["grad_norm"])
    err = max(float((a.detach().cpu() - b.detach()).abs().max())
              for a, b in zip(s_card.params.parameters(),
                              s_cpu.params.parameters()))
    what = f"train_kinds {name} (reduced-precision reduction " \
           f"{'on' if reduced_precision else 'off'})"
    require(gerr <= CARD_GRAD_TOL, f"{what}: every leaf's gradient within "
            f"{CARD_GRAD_TOL} of its largest magnitude (max {gerr})")
    require(abs(loss - want) <= CARD_LOSS_RTOL * abs(want),
            f"{what}: loss {loss} against the CPU's {want}")
    require(abs(gn - gn_want) <= CARD_GNORM_RTOL * abs(gn_want),
            f"{what}: grad norm {gn} against the CPU's {gn_want}")
    require(err <= CARD_PARAM_ATOL, f"{what}: params within "
            f"{CARD_PARAM_ATOL} of the CPU's (max {err})")
    # a recurrent layer's scan and its backward run the kernel on the card
    # and the plain version on the CPU: forward, recompute and reversed
    # scan (remat "full") in the gradients and again in the step
    recurrent = sum(k in ("mamba", "rglru") for k in layer_kinds(cfg))
    require(launches["linear_scan"] == 6 * recurrent,
            f"{what}: linear_scan launched {launches['linear_scan']} times, "
            f"not 6 a recurrent layer ({recurrent})")
    return {"loss": loss, "cpu_loss": want, "grad_norm": gn,
            "cpu_grad_norm": gn_want, "grad_max_rel_err": gerr,
            "param_max_abs_err": err,
            "linear_scan_launches": launches["linear_scan"]}


def train_resume(torch, row):
    """The reduced phi4-mini on the card: 6 steps checkpointed at step 3,
    restored and replayed; ``--accum 2`` against ``--accum 1``; and
    ``--compress-grads`` through the entry point."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.ft.coordinator import Coordinator, FTConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.train import loop as train_loop
    from repro_torch.train.optimizer import OptimizerConfig, global_norm
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    dev = torch.device("cuda", 0)
    cfg = reduced_config(TRAIN_ARCH)
    oc = OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=50)
    step_fn = make_train_step(cfg, oc)

    def src(i):
        return synthetic_batch(cfg, 4, 32, i, device=dev)

    def fresh(seed=SEED, compression=False):
        return init_state(init_params(cfg, seed, device=dev,
                                      dtype=torch.float32),
                          compression=compression)

    ckpt = os.path.join(DATA, "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    _, hist = train_loop.run(fresh(), step_fn, src, num_steps=6,
                             ckpt_dir=ckpt, log=lambda s: None,
                             coordinator=Coordinator(FTConfig(ckpt_every=3)))
    require(ckpt_io.latest_step(ckpt) == 6, "train_resume: checkpoints")
    restored, at = ckpt_io.restore(fresh(SEED + 1), ckpt, 3)
    require(at == 3 and int(restored.step) == 3 and restored.step.is_cuda,
            "train_resume: restored at step 3 on the card")
    _, again = train_loop.run(restored, step_fn, src, num_steps=6,
                              log=lambda s: None)
    a, b = [h["loss"] for h in hist[3:]], [h["loss"] for h in again]
    worst = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    require(worst <= 1e-5, f"train_resume: the replayed steps' losses "
            f"{b} against the uninterrupted run's {a}")
    shutil.rmtree(ckpt, ignore_errors=True)
    full = get_config(TRAIN_ARCH)
    row["resume"] = {"losses": a, "replayed": b, "max_rel_err": worst,
                     "ckpt_steps": [3, 6], "reduced": {
                         "config": f"reduced_config({TRAIN_ARCH!r})",
                         "reason": f"a full-width checkpoint writes f32 "
                         f"params, mu and nu: "
                         f"{12 * (full.param_count() + full.d_model) / 1e9:.1f}"
                         f" GB to disk a save"}}

    one, two = fresh(), fresh()
    batch = synthetic_batch(cfg, 8, 32, 0, device=dev)
    s1, m1 = step_fn(one, batch)
    s2, m2 = make_train_step(cfg, oc, accum_steps=2)(two, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    perr = max(float(((p - q).abs() - 2e-3 * q.abs()).max().detach())
               for p, q in zip(s2.params.parameters(),
                               s1.params.parameters()))
    require(abs(l1 - l2) <= 1e-5 * abs(l1) and perr <= 2e-5,
            f"train_resume: --accum 2 against --accum 1 (loss {l2} vs "
            f"{l1}; params past rtol 2e-3 by {perr})")
    row["accum"] = {"loss_accum1": l1, "loss_accum2": l2,
                    "params_past_rtol_2e-3": perr}

    seen = {}

    def run(real, args, kw):
        out = real(*args, **kw)
        seen["state"] = out[0]
        return out
    with spy_on(train_loop, "run", run):
        rc = launch_train.main(["--arch", TRAIN_ARCH, "--reduced", "--steps",
                                "3", "--batch", "4", "--seq", "32",
                                "--compress-grads"])
    err = float(global_norm(seen["state"].error.values()))
    require(rc == 0 and err > 0, f"train_resume: --compress-grads carries "
            f"an error buffer (norm {err})")
    row["compress_grads"] = {"error_norm": err}
    del one, two, s1, s2, seen


def phase_train_lm(torch, kernels, text_path, report):
    """LM training on the card (phase 3h): phi4-mini-3.8b at full width and
    depth through ``repro_torch.launch.train`` over the scale-22 text, the
    six kinds' reduced archs against the CPU, and checkpoint, resume,
    accumulation and compression on the reduced config.  Returns the
    loader's launch counts inside training."""
    t_phase = time.perf_counter()
    free_card(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row = {"allocated_before_bytes": torch.cuda.memory_allocated()}
    report["train_lm"] = row            # kept whole if a check fails
    lc = train_headline(torch, kernels, text_path, row)
    free_card(torch)
    say(json.dumps({"train_lm": row}))

    kinds = {}
    for name in TRAIN_KINDS:
        kinds[name] = {"default": kind_step(torch, name, True),
                       "reduced_precision_reduction_off":
                       kind_step(torch, name, False)}
    row["kinds"] = {"tol": {"grad_tol": CARD_GRAD_TOL,
                            "loss_rtol": CARD_LOSS_RTOL,
                            "grad_norm_rtol": CARD_GNORM_RTOL,
                            "param_atol": CARD_PARAM_ATOL}, "archs": kinds}
    train_resume(torch, row)
    free_card(torch)
    row["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps({"train_lm_checks": {k: row[k] for k in (
        "kinds", "resume", "accum", "compress_grads", "phase_s")}}))
    say("phase 3h: phi4-mini-3.8b trains at full width and depth on the "
        "card; every kind's step agrees with the CPU")
    return {"train_lm: the text load inside training": lc}


# ---------------------------------------------------------------------------
# phase 3i: data-parallel training (int8 collectives, local accumulation,
# ZeRO-1), its checkpoints and the elastic restore
# ---------------------------------------------------------------------------

DP_STEPS, DP_ACCUM = 4, 2
DP_SKIP = 2              # steps left out of the step median (steps 2-3 kept)
# full width: lr 3e-5 (3h: 1e-3 diverges there) from step 0 (no warm-up),
# so step 0 moves every parameter and the comparison with make_train_step
# bites; the reduced checks keep the reference tests' config
DP_FULL_OC = dict(lr=3e-5, warmup_steps=0, decay_steps=100)
DP_REDUCED_OC = dict(lr=1e-3, warmup_steps=1, decay_steps=50)
# step 0 of the ZeRO-1 step at d=1 against make_train_step on the same
# weights and batch: the same gradients, summed in another order for the
# norm
DP_LOSS_RTOL, DP_GNORM_RTOL = 1e-5, 1e-3
DP_LEAF_TOL = dict(rtol=5e-3, atol=5e-5)
# d=2 on one card against the single-card step after one step (the
# reference tests' bounds: tests/test_distributed_loader.py)
DP_LOCAL_TOL = dict(rtol=3e-3, atol=3e-5)
DP_ZERO1_TOL = dict(rtol=5e-3, atol=5e-5)
DP_ALLREDUCE_LEN = 4097              # odd: the padding path


def dp_leaves(cfg):
    """The leaves held at full width (port names): the embedding, the
    first and last layers' ``wq`` and ``mlp.w_in``, the final norm."""
    last = cfg.num_layers - 1
    return ("embed", "layers.0.attn.wq", "layers.0.mlp.w_in",
            f"layers.{last}.attn.wq", f"layers.{last}.mlp.w_in",
            "final_norm")
COLLECTIVES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
               "all_gather", "all_to_all_single", "broadcast")


@contextlib.contextmanager
def collective_bytes(row):
    """For the block, every ``torch.distributed`` collective of
    ``COLLECTIVES`` adds its calls and the bytes of the tensor it sends
    to ``row[name]``."""
    import torch.distributed as dist
    reals = {name: getattr(dist, name) for name in COLLECTIVES}

    def counting(name, real):
        def call(*args, **kw):
            sent = args[0] if name in ("all_reduce", "broadcast") else args[1]
            slot = row.setdefault(name, {"calls": 0, "bytes": 0})
            slot["calls"] += 1
            slot["bytes"] += sent.numel() * sent.element_size()
            return real(*args, **kw)
        return call
    for name, real in reals.items():
        setattr(dist, name, counting(name, real))
    try:
        yield row
    finally:
        for name, real in reals.items():
            setattr(dist, name, real)


def param_checksum(torch, model):
    """Two sums over every parameter's bit patterns (plain and weighted by
    position), as Python ints: equal models give equal sums."""
    chunk = 1 << 24
    weights = torch.arange(chunk, dtype=torch.int64,
                           device=next(model.parameters()).device) % 65521 + 1
    a = b = 0
    for k, p in enumerate(model.parameters()):
        bits = p.detach().reshape(-1).view(torch.int32)
        for part in bits.split(chunk):
            w = part.to(torch.int64)
            a += int(w.sum()) * (k + 1)
            b += int((w * weights[:w.numel()]).sum())
    return [a, b]


def plain_compressed_allreduce(torch, xs):
    """The int8 all-reduce of the rows of ``xs`` (one a rank) in one
    process: each rank's send payload and scale, each segment's summed
    payload and scale, and the result every rank gets."""
    from repro_torch.distributed.compression import quantize_int8
    n = xs.shape[0]
    flat = xs.reshape(n, -1)
    pad = (-flat.shape[1]) % n
    flat = torch.cat([flat, flat.new_zeros(n, pad)], dim=1)
    sends = [quantize_int8(row.view(n, -1)) for row in flat]
    sums = []
    for k in range(n):
        acc = sends[0][0][k].double() * sends[0][1].double()
        for j in range(1, n):      # the product exact in f64, as an FMA's
            acc = (acc.float().double()
                   + sends[j][0][k].double() * sends[j][1].double())
        sums.append(quantize_int8(acc.float()))
    y = torch.cat([q.float() * s for q, s in sums])
    return sends, sums, (y[:-pad] if pad else y)


def dp_step_errs(torch, got, want, tol):
    """The largest amount by which any element of ``got`` misses ``want``
    past ``tol`` (<= 0 inside it)."""
    return max(float(((a.detach() - b.detach()).abs()
                      - tol["rtol"] * b.detach().abs()).max()) - tol["atol"]
               for a, b in zip(got.parameters(), want.parameters()))


def dp_checks(torch, mesh, rank, world, cfg_row):
    """One rank of phase 3i's d > 1 world on one card (reduced phi4-mini):
    the int8 all-reduce against its plain version; the local-accumulation,
    int8 and ZeRO-1 steps against the single-card step; 3 steps of each,
    their params' checksums; ZeRO-1 saved at step 2, restored, replayed;
    the local state saved at step 3 for the parent's elastic restore."""
    import copy
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.distributed import compression
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.train.step import (make_local_accum_train_step,
                                        make_train_step,
                                        make_zero1_local_state,
                                        reference_leaves)
    dev = mesh_device(mesh)
    row = {}
    g = torch.Generator().manual_seed(SEED)
    xs = (torch.randn((world, DP_ALLREDUCE_LEN), generator=g)
          * torch.tensor([1.0, 10.0, 0.1, 3.0][:world])[:, None]).to(dev)
    seen, real = [], compression.quantize_int8

    def recording(t):
        q, s = real(t)
        seen.append((q, s))
        return q, s
    compression.quantize_int8 = recording
    try:
        y = compression.compressed_allreduce(xs[rank], mesh, "data")
    finally:
        compression.quantize_int8 = real
    y2 = compression.compressed_psum(xs[rank], mesh, "data")
    sends, sums, want_y = plain_compressed_allreduce(torch, xs)
    (q1, s1), (q2, s2) = seen
    exact = xs.sum(0)
    scale = float(exact.abs().max())
    row["allreduce"] = {
        "payloads_bitwise": bool(
            torch.equal(q1, sends[rank][0]) and torch.equal(s1, sends[rank][1])
            and torch.equal(q2, sums[rank][0])
            and torch.equal(s2, sums[rank][1])),
        "result_bitwise": bool(torch.equal(y, want_y)),
        "err": float((y - exact).abs().max()) / scale,
        "psum_err": float((y2 - exact).abs().max()) / scale}

    cfg = reduced_config(TRAIN_ARCH)
    oc = OptimizerConfig(**DP_REDUCED_OC)
    batch = synthetic_batch(cfg, 8, 32, 0, device=dev)
    base = init_params(cfg, SEED, device=dev, dtype=torch.float32)
    single = make_train_step(cfg, oc, accum_steps=DP_ACCUM)
    s_one, m_one = single(init_state(copy.deepcopy(base)), batch)
    want_flat = {path: torch.cat([s_one.mu[n].reshape(-1) for n, _ in members])
                 for path, members in reference_leaves(s_one.params).items()}
    for mode, tol in (("local", DP_LOCAL_TOL), ("int8", None),
                      ("zero1", DP_ZERO1_TOL)):
        model = copy.deepcopy(base)
        state = make_zero1_local_state(model, world, mesh=mesh) \
            if mode == "zero1" else init_state(model)
        step = make_local_accum_train_step(
            cfg, oc, mesh, accum_steps=DP_ACCUM, zero1=mode == "zero1",
            int8_allreduce=mode == "int8")
        state, m = step(state, batch)
        r = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "single_loss": float(m_one["loss"]),
             "single_grad_norm": float(m_one["grad_norm"])}
        if tol is not None:
            r["params_past_tol"] = dp_step_errs(torch, state.params,
                                                s_one.params, tol)
        if mode == "local":
            r["mu_err"] = max(float((state.mu[n] - s_one.mu[n]).abs().max()
                                    / s_one.mu[n].abs().max())
                              for n in s_one.mu)
        if mode == "zero1":
            errs = []
            for path, want in want_flat.items():
                mine = state.mu[path].to_local()[0]
                c = mine.numel()
                part = want[rank * c:(rank + 1) * c]
                errs.append(float((mine[:part.numel()] - part).abs().max()
                                  / want.abs().max()))
            r["mu_err"] = max(errs)
            r["mu_rows"] = {k: list(v.shape) for k, v in state.mu.items()}
        state, _ = step(state, batch)
        if mode == "zero1":
            ckpt = os.path.join(cfg_row["out"], "zero1")
            ckpt_io.save(state, ckpt, 2)
        state, _ = step(state, batch)
        r["checksum"] = param_checksum(torch, state.params)
        if mode == "zero1":
            again = make_zero1_local_state(
                init_params(cfg, SEED + 1, device=dev, dtype=torch.float32),
                world, mesh=mesh)
            again, at = ckpt_io.restore(again, ckpt)
            again, _ = step(again, batch)
            r["replayed_bitwise"] = bool(
                at == 2 and all(torch.equal(a, b) for a, b in zip(
                    again.params.parameters(), state.params.parameters()))
                and all(torch.equal(again.mu[k].to_local(),
                                    state.mu[k].to_local())
                        for k in state.mu))
        if mode == "local":
            ckpt_io.save(state, os.path.join(cfg_row["out"], "param_state"), 3)
        row[mode] = r
        del state, model
    return row


def dp_cards(torch, kernels, mesh, rank, world, cfg_row):
    """One rank of ``--cards N``'s training world: phi4-mini-3.8b at full
    width over NCCL, one card a rank, on walks over the scale-22 text
    (loaded by each rank, its launches counted); 4 ZeRO-1 steps and 4 int8
    steps from the seed's weights (broadcast from rank 0)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import graph_walk_source
    from repro_torch.distributed.collectives import mesh_device
    dev = mesh_device(mesh)
    cfg = get_config(TRAIN_ARCH)
    source = graph_walk_source(cfg_row["path"], cfg, TRAIN_BATCH, TRAIN_SEQ,
                               device=dev)
    batches, load_s, lc = counted(
        torch, kernels, lambda: [source(i) for i in range(DP_STEPS)])
    need(lc, LOAD_KERNELS, f"train_dp d={world} rank {rank}: the text load")
    row = {"text_and_batches_s": load_s, "launches": lc}
    for mode in ("zero1", "int8"):
        row[mode] = dp_run(torch, cfg, mesh, world, mode, batches,
                           broadcast=True)
    del batches, source
    return row


def dp_run(torch, cfg, mesh, world, mode, batches, broadcast=False,
           capture=None):
    """``DP_STEPS`` steps of the data-parallel step in ``mode`` (``zero1``
    or ``int8``) at ``cfg`` from the seed's weights: losses, step ms, the
    median of steps 2-3, tokens/s, peak memory, the moments' bytes on this
    rank, the collectives' calls and bytes a step, the params' checksum.
    ``capture``: host copies of ``dp_leaves(cfg)`` after step 0 go
    there."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import (make_local_accum_train_step,
                                        make_zero1_local_state)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, SEED, device=mesh_device(mesh),
                        dtype=torch.float32)
    if broadcast:
        for p in model.parameters():
            dist.broadcast(p.detach(), src=0)
    state = make_zero1_local_state(model, world, mesh=mesh) \
        if mode == "zero1" else init_state(model)
    moments = sum((t.to_local() if hasattr(t, "to_local") else t).numel() * 4
                  for t in list(state.mu.values()) + list(state.nu.values()))
    step = make_local_accum_train_step(
        cfg, OptimizerConfig(**DP_FULL_OC), mesh, remat_policy="full",
        accum_steps=DP_ACCUM, zero1=mode == "zero1",
        int8_allreduce=mode == "int8")
    losses, norms, ms, coll = [], [], [], {}
    for i in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == DP_STEPS - 1:
            with collective_bytes(coll):
                state, m = step(state, batches[i])
                loss = float(m["loss"])
        else:
            state, m = step(state, batches[i])
            loss = float(m["loss"])
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        norms.append(float(m["grad_norm"]))
        if i == 0 and capture is not None:
            named = dict(state.params.named_parameters())
            capture.update({n: named[n].detach().to("cpu", copy=True)
                            for n in dp_leaves(cfg)},
                           loss=loss, grad_norm=norms[0])
    med = spread(ms[DP_SKIP:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row = {"losses": losses, "grad_norms": norms, "step_ms": ms,
           "step_ms_steps_2_3": med, "tokens_per_s": tokens / (med["p50"]
                                                               / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "moment_bytes_this_rank": moments,
           "collectives_last_step": coll,
           "checksum": param_checksum(torch, state.params)}
    require(all(np.isfinite(losses)), f"train_dp {mode} d={world}: finite "
            f"losses ({losses})")
    del state, model, step
    free_card(torch)
    return row


def dp_rank(cfg_path) -> int:
    """One rank of a phase-3i world (``--dp-rank``): ``dp_checks`` over
    gloo on one card, or ``dp_cards`` over NCCL, one card a rank."""
    import torch
    from repro_torch import kernels
    from repro_torch.scripts import local_world
    with open(cfg_path) as f:
        cfg = json.load(f)
    torch.cuda.set_device(int(os.environ["RANK"])
                          % torch.cuda.device_count())
    world = int(os.environ["WORLD_SIZE"])
    mesh, rank, world = local_world.join(cfg["backend"], "cuda", (world, 1),
                                         ("data", "model"))
    try:
        if cfg["mode"] == "check":
            row = dp_checks(torch, mesh, rank, world, cfg)
        else:
            row = dp_cards(torch, kernels, mesh, rank, world, cfg)
    finally:
        local_world.leave()
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    return 0


def dp_world(mode, world, backend, path=None):
    """A world of ``world`` ranks of this script (:func:`dp_rank`); returns
    ``(wall seconds, every rank's row, its directory)``."""
    from repro_torch.scripts import local_world
    out = os.path.join(OUT, f"dp_{mode}{world}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg = os.path.join(out, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"mode": mode, "backend": backend, "out": out,
                   "path": path}, f)
    t0 = time.perf_counter()
    runs = local_world.spawn([sys.executable, os.path.abspath(__file__),
                              "--dp-rank", cfg], world, timeout=600,
                             workdir=out)
    wall = time.perf_counter() - t0
    rows = []
    for k, run in enumerate(runs):
        require(run.returncode == 0, f"train_dp {mode} d={world} over "
                f"{backend}: rank {k} exited {run.returncode}:\n"
                f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
        with open(os.path.join(out, f"rank{k}.json")) as f:
            rows.append(json.load(f))
    return wall, rows, out


def check_d2(rows):
    """Phase 3i (b)'s requirements over its two ranks' rows."""
    for k, r in enumerate(rows):
        ar = r["allreduce"]
        require(ar["payloads_bitwise"] and ar["result_bitwise"],
                f"train_dp d=2 rank {k}: compressed_allreduce's payloads and "
                f"result equal its plain version's bitwise")
        require(ar["err"] < 0.03 and ar["psum_err"] < 0.01,
                f"train_dp d=2 rank {k}: int8 sums within 0.03 / 0.01 of the "
                f"exact sum ({ar['err']}, {ar['psum_err']})")
        for mode in ("local", "int8", "zero1"):
            m = r[mode]
            require(abs(m["loss"] - m["single_loss"])
                    <= CARD_LOSS_RTOL * abs(m["single_loss"])
                    and abs(m["grad_norm"] - m["single_grad_norm"])
                    <= CARD_GNORM_RTOL * m["single_grad_norm"],
                    f"train_dp d=2 rank {k} {mode}: loss and grad norm "
                    f"against the single-card step ({m})")
            if mode != "int8":
                require(m["params_past_tol"] <= 0 and
                        m["mu_err"] <= CARD_GRAD_TOL,
                        f"train_dp d=2 rank {k} {mode}: params and moments "
                        f"against the single-card step ({m})")
        require(r["zero1"]["replayed_bitwise"], f"train_dp d=2 rank {k}: "
                f"ZeRO-1 saved at step 2, restored and replayed bitwise")
    for mode in ("local", "int8", "zero1"):
        require(rows[0][mode]["checksum"] == rows[1][mode]["checksum"],
                f"train_dp d=2 {mode}: params bitwise equal on both ranks "
                f"after 3 steps")


def dp_reshard_into_one(torch, cfg, mesh, directory):
    """The d=2 param-shaped state restored into this world of one with
    ``fsdp=True``: every leaf's ``full_tensor()`` equals the saved one."""
    from repro_torch.checkpoint.reshard import reshard_restore
    from repro_torch.models.transformer import reference_paths
    from repro_torch.train.state import abstract_state
    state, at = reshard_restore(abstract_state(cfg), directory, cfg, mesh,
                                fsdp=True)
    paths = reference_paths(state.params)
    d = os.path.join(directory, f"step_{at:08d}")
    checked = 0
    for idx, tree in (("1", dict(state.params.named_parameters())),
                      ("2", state.mu), ("3", state.nu)):
        for name, t in tree.items():
            path, j = paths[name]
            saved = np.load(os.path.join(d, f"{idx}.{path}.npy"))
            saved = saved if j is None else saved[j]
            require(np.array_equal(t.detach().full_tensor().cpu().numpy(), saved),
                    f"train_dp reshard: {idx}.{name} bitwise")
            checked += 1
    require(int(state.step) == at == 3 and all(
        hasattr(p, "to_local") for p in state.params.parameters()),
        "train_dp reshard: step 3, DTensor parameters")
    return {"leaves": checked, "step": at}


def dp_full_width(torch, kernels, mesh, text_path, row):
    """Phase 3i (a), in this process's NCCL world of one: the text load
    for the walk batches (launches counted), 4 ZeRO-1 steps, 4 int8 steps,
    then step 0 of ``make_train_step`` from the same seed on the same
    batch against the ZeRO-1 step's."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import graph_walk_source
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    cfg = get_config(TRAIN_ARCH)
    dev = mesh_device(mesh)
    source = graph_walk_source(text_path, cfg, TRAIN_BATCH, TRAIN_SEQ,
                               device=dev)
    batches, row["text_and_batches_s"], lc = counted(
        torch, kernels, lambda: [source(i) for i in range(DP_STEPS)])
    need(lc, LOAD_KERNELS, "train_dp d=1: the text load for the walks")
    row.update(arch=TRAIN_ARCH, layers=cfg.num_layers, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, accum_steps=DP_ACCUM, remat="full",
               optimizer=DP_FULL_OC, reduced=None, launches=lc)
    captured = {}
    row["zero1"] = dp_run(torch, cfg, mesh, 1, "zero1", batches,
                          capture=captured)
    say(json.dumps({"train_dp_zero1": row["zero1"]}))
    row["int8"] = dp_run(torch, cfg, mesh, 1, "int8", batches)
    say(json.dumps({"train_dp_int8": row["int8"]}))
    ln_v = float(np.log(cfg.vocab_size))
    require(abs(row["zero1"]["losses"][0] - ln_v) < 2.0,
            f"train_dp: step 0's loss near ln V = {ln_v}")

    state = init_state(init_params(cfg, SEED, device=dev,
                                   dtype=torch.float32))
    step = make_train_step(cfg, OptimizerConfig(**DP_FULL_OC),
                           remat_policy="full", accum_steps=DP_ACCUM)
    state, m = step(state, batches[0])
    named = dict(state.params.named_parameters())
    want = {n: named[n].detach().to("cpu", copy=True)
            for n in dp_leaves(cfg)}
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    del state, step, named, batches, source
    free_card(torch)
    errs = {}
    for n in dp_leaves(cfg):
        a, b = captured[n], want[n]
        errs[n] = float(((a - b).abs() - DP_LEAF_TOL["rtol"] * b.abs()).max()
                        - DP_LEAF_TOL["atol"])
        require(errs[n] <= 0, f"train_dp: ZeRO-1's step 0 {n} within "
                f"{DP_LEAF_TOL} of make_train_step's (past it by {errs[n]})")
    require(abs(captured["loss"] - loss) <= DP_LOSS_RTOL * abs(loss)
            and abs(captured["grad_norm"] - gnorm) <= DP_GNORM_RTOL * gnorm,
            f"train_dp: ZeRO-1's step 0 loss {captured['loss']} / grad norm "
            f"{captured['grad_norm']} against make_train_step's {loss} / "
            f"{gnorm}")
    row["against_make_train_step"] = {
        "loss": captured["loss"], "want_loss": loss,
        "grad_norm": captured["grad_norm"], "want_grad_norm": gnorm,
        "leaves_past_tol": errs, "tol": {"loss_rtol": DP_LOSS_RTOL,
                                         "grad_norm_rtol": DP_GNORM_RTOL,
                                         **DP_LEAF_TOL}}
    return lc


def phase_train_dp(torch, kernels, text_path, report):
    """Data-parallel training on the card (phase 3i): (b) a world of two
    ranks over gloo on this one card at the reduced phi4-mini, then, in an
    NCCL world of one in this process, the elastic restore of (b)'s state
    and (a) phi4-mini-3.8b at full width and depth.  Returns the loader's
    launch counts."""
    import torch.distributed as dist
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    free_card(torch)
    row = {}
    report["train_dp"] = row            # kept whole if a check fails
    wall, rows, out = dp_world("check", 2, "gloo")
    check_d2(rows)
    row["d2_on_one_card"] = {"what": "a test of the d > 1 arithmetic on one "
                             "card over gloo, not a deployment",
                             "world_s": wall, "ranks": rows}
    say(json.dumps({"train_dp_d2": row["d2_on_one_card"]}))

    init = os.path.join(OUT, "dp1.rendezvous")
    if os.path.exists(init):
        os.remove(init)
    dist.init_process_group("nccl", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        row["reshard_d2_to_d1"] = dp_reshard_into_one(
            torch, reduced_config(TRAIN_ARCH), mesh,
            os.path.join(out, "param_state"))
        shutil.rmtree(out, ignore_errors=True)
        lc = dp_full_width(torch, kernels, mesh, text_path, row)
    finally:
        dist.destroy_process_group()
    row["phase_s"] = time.perf_counter() - t_phase
    say(json.dumps({"train_dp": {k: v for k, v in row.items()
                                 if k != "d2_on_one_card"}}))
    say("phase 3i: data-parallel training (d=2 over gloo on one card, "
        "d=1 over NCCL at full width) checks out on the card")
    return {"train_dp: the text load for the walks": lc}


def train_dp_across_cards(torch, cards, path22):
    """``--cards N``'s training world: N ranks over NCCL, one card each,
    phi4-mini-3.8b at full width; losses equal on every rank, the params'
    checksums equal after the steps."""
    wall, rows, out = dp_world("cards", cards, "nccl", path22)
    shutil.rmtree(out, ignore_errors=True)
    for mode in ("zero1", "int8"):
        require(all(r[mode]["losses"] == rows[0][mode]["losses"]
                    for r in rows), f"--cards {cards} {mode}: the losses "
                f"equal on every rank")
        require(all(r[mode]["checksum"] == rows[0][mode]["checksum"]
                    for r in rows), f"--cards {cards} {mode}: the params "
                f"equal on every rank after {DP_STEPS} steps")
    return {"world_s": wall, "ranks": rows}


# ---------------------------------------------------------------------------
# phase 3j: tensor-parallel execution over a "model" axis
# ---------------------------------------------------------------------------

TP_ARCHS = ("nemotron-4-15b", "granite-20b", "starcoder2-7b",
            "phi4-mini-3.8b", "recurrentgemma-2b", "mixtral-8x22b",
            "llama4-maverick-400b-a17b", "musicgen-large",
            "llama-3.2-vision-11b", "falcon-mamba-7b")
TP_REDUCED_STEPS = 8      # decode steps of each reduced arch
TP_REDUCED_SEQ, TP_REDUCED_MAX = 16, 32
TP_SERVE_BATCH, TP_SERVE_PROMPT, TP_SERVE_STEPS = 8, 32, 16
TP_SERVE_MAX = 64
TP_TRAIN_LAYERS = 4       # full width, cut in depth (module docstring)
# the repo's tolerances (tests/torch_train_ref.py, tests/torch_models_ref.py,
# tests/torch_lm.py): the sharded run against the unsharded one of the same
# padded parameters on the card
TP_LOSS_RTOL, TP_GRAD_TOL, TP_LOGIT_TOL = 5e-4, 5e-2, 2e-2
TP_GNORM_RTOL = 1e-2      # five times TRAIN_RTOL, as the step tests hold it
MARGIN_TOL = 0.1          # two greedy streams part only below this margin


def tp_forward(torch, model, cfg, batch, tokens):
    """Loss, whole gradients, prefill logits and teacher-forced decode
    logits of ``model`` (sharded or not)."""
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.models import loss_fn
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, cfg)
    loss.backward()
    lay, mg = getattr(model, "layouts", {}), getattr(model, "mg", None)
    grads = {n: tpar.whole(p.grad, lay.get(n), mg)
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    prompt = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
              for k, v in batch.items() if k != "labels"}
    prefill = make_prefill_step(cfg, TP_REDUCED_MAX, tp=model.tp)
    decode = make_decode_step(cfg, TP_REDUCED_MAX, tp=model.tp)
    lg, caches = prefill(model, prompt)
    logits = [lg.float()]
    b = lg.shape[0]
    for i in range(TP_REDUCED_STEPS):
        pos = torch.full((b,), TP_REDUCED_SEQ + i, dtype=torch.int32,
                         device=lg.device)
        _, lg, caches = decode(model, caches, {"token": tokens[i],
                                               "pos": pos})
        logits.append(lg.float())
    return float(loss.detach()), grads, logits, caches


def tp_reduced_checks(torch, mesh, rank):
    """Phase 3j (a), one rank of the (1, 2) world on one card: every
    reduced arch from ``init_params(cfg, SEED, tp=2)``, sharded, against
    the unsharded run of the same padded parameters."""
    import copy
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.distributed.sharding import cache_model_dim
    from repro_torch.models import init_params
    from repro_torch.models.transformer import init_caches
    dev = mesh_device(mesh)
    tp = mesh.mesh.shape[1]
    # cuBLAS's bf16 reduced-precision reduction off: the sharded run sums
    # its row-parallel partial products in f32, and the unsharded one
    # should not carry an error of its own into the comparison
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    for arch in TP_ARCHS:
        cfg = reduced_config(arch)
        base = init_params(cfg, SEED, tp=tp, device=dev, dtype=torch.float32)
        batch = synthetic_batch(cfg, 2, TP_REDUCED_SEQ, 0, device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        tokens = torch.randint(0, cfg.vocab_size, (TP_REDUCED_STEPS, 2),
                               generator=g, device=dev, dtype=torch.int32)
        l0, g0, o0, _ = tp_forward(torch, copy.deepcopy(base), cfg, batch,
                                   tokens)
        cpu = {k: v.cpu() for k, v in batch.items()}
        _, _, on_cpu, _ = tp_forward(torch, copy.deepcopy(base).cpu(), cfg,
                                     cpu, tokens.cpu())
        sharded = tpar.shard_model(base, cfg, mesh)
        l1, g1, o1, caches = tp_forward(torch, sharded, cfg, batch, tokens)
        gerr = max(float((g1[n] - g0[n]).abs().max()
                         / g0[n].abs().max().clamp_min(1e-30)) for n in g0)
        # at TP_LOGIT_TOL beyond the unsharded run's own spread between
        # the card and the CPU (bf16 GEMMs of other shapes round
        # differently on the card, and a flip in the residual stream
        # grows with depth), as tests/torch_models_ref.hold_compiled
        # holds the port beyond the reference's compiled/op-by-op spread
        lerr, raw, spread = -1.0, 0.0, 0.0
        for a, b, c in zip(o1, o0, on_cpu):
            own = (c.to(b.device) - b).abs()
            d = (a - b).abs()
            raw, spread = max(raw, float(d.max())), max(spread,
                                                        float(own.max()))
            lerr = max(lerr, float((d - own - TP_LOGIT_TOL * (1 + b.abs()))
                                   .max()))
        whole = init_caches(cfg, 2, TP_REDUCED_MAX, device="meta")
        split = 0
        for c, w in zip(caches, whole):
            for k, t in c.items():
                dim = cache_model_dim(k, tuple(w[k].shape), cfg, tp)
                want = list(w[k].shape)
                if dim is not None:
                    want[dim] //= tp
                    split += 1
                require(list(t.shape) == want, f"tp_reduced {arch} rank "
                        f"{rank}: cache {k} {list(t.shape)} != {want}")
        out[arch] = {"loss": l1, "unsharded_loss": l0, "grad_err": gerr,
                     "logits_past_tol": lerr, "logits_max_diff": raw,
                     "card_cpu_spread": spread, "cache_leaves_split": split,
                     "param_bytes_rank": sum(p.numel() * p.element_size()
                                             for p in sharded.parameters())}
        del base, sharded, g0, g1
    return out


def tp_step_checks(torch, mesh, rank):
    """Phase 3j (a), one rank of the (2, 2) world on one card: the reduced
    phi4-mini's f32, int8 and ZeRO-1 steps against ``make_train_step``
    from the same weights on the same batch."""
    import copy
    from repro_torch.configs import reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import (make_local_accum_train_step,
                                        make_train_step,
                                        make_zero1_local_state)
    dev = mesh_device(mesh)
    n_dp, tp = mesh.mesh.shape
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = reduced_config(TRAIN_ARCH)
    oc = OptimizerConfig(**DP_REDUCED_OC)
    batch = synthetic_batch(cfg, 8, 32, 0, device=dev)
    base = init_params(cfg, SEED, tp=tp, device=dev, dtype=torch.float32)
    want, m_one = make_train_step(cfg, oc, accum_steps=DP_ACCUM)(
        init_state(copy.deepcopy(base)), batch)
    row = {}
    for mode, tol in (("local", DP_LOCAL_TOL), ("int8", None),
                      ("zero1", DP_ZERO1_TOL)):
        model = tpar.shard_model(copy.deepcopy(base), cfg, mesh)
        state = make_zero1_local_state(model, n_dp, tp, mesh=mesh) \
            if mode == "zero1" else init_state(model)
        step = make_local_accum_train_step(
            cfg, oc, mesh, accum_steps=DP_ACCUM, zero1=mode == "zero1",
            int8_allreduce=mode == "int8")
        state, m = step(state, batch)
        r = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "single_loss": float(m_one["loss"]),
             "single_grad_norm": float(m_one["grad_norm"])}
        tpar.gather_model(state.params)
        if tol is not None:
            r["params_past_tol"] = dp_step_errs(torch, state.params,
                                                want.params, tol)
        if mode == "zero1":
            r["moment_block"] = list(next(iter(state.mu.values()))
                                     .to_local().shape)
        row[mode] = r
        del state, model
    return row


def tp_prompts(torch, kernels, cfg, text_path, dev):
    """``TP_SERVE_BATCH`` prompts from GVEL walks of the text graph (its
    load counted): the first batch of ``graph_walk_source``."""
    from repro_torch.data.pipeline import graph_walk_source
    source = graph_walk_source(text_path, cfg, TP_SERVE_BATCH,
                               TP_SERVE_PROMPT, device=dev)
    batch, load_s, lc = counted(torch, kernels, lambda: source(0))
    return batch["tokens"], load_s, lc


def tp_decode_run(torch, model, cfg, prompts, tp, record=None):
    """Prefill ``prompts`` and ``TP_SERVE_STEPS`` greedy steps: tokens,
    each step's ms (CUDA events), the collectives of the last step and,
    from one traced step, its launches."""
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    prefill = make_prefill_step(cfg, TP_SERVE_MAX, tp=tp)
    decode = make_decode_step(cfg, TP_SERVE_MAX, tp=tp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = prefill(model, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    def margin(lg):
        top = torch.topk(lg.float(), 2, dim=-1).values
        return (top[:, 0] - top[:, 1]).cpu().tolist()
    nxt = torch.argmax(lg, dim=-1).to(torch.int32)
    tokens, margins, ms, coll = [nxt.cpu().tolist()], [margin(lg)], [], {}
    b = prompts.shape[0]
    for i in range(TP_SERVE_STEPS):
        pos = torch.full((b,), TP_SERVE_PROMPT + i, dtype=torch.int32,
                         device=prompts.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == TP_SERVE_STEPS - 1:
            with collective_bytes(coll):
                nxt, lg, caches = decode(model, caches, {"token": nxt,
                                                         "pos": pos})
        else:
            nxt, lg, caches = decode(model, caches, {"token": nxt,
                                                     "pos": pos})
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        margins.append(margin(lg))
        tokens.append(nxt.cpu().tolist())
    pos = torch.full((b,), TP_SERVE_PROMPT, dtype=torch.int32,
                     device=prompts.device)
    with traced(torch) as prof:
        decode(model, caches, {"token": nxt, "pos": pos})
    launches, _ = card_records(prof)
    med = spread(ms[2:])
    return {"tokens": tokens, "margins": margins, "prefill_ms": prefill_ms,
            "step_ms": ms, "step_ms_after_2": med,
            "tokens_per_s": b / (med["p50"] / 1e3),
            "launches_per_step": len(launches),
            "collectives_per_step": coll,
            "cache_bytes_rank": cache_bytes(caches),
            "weight_bytes_rank": sum(p.numel() * p.element_size()
                                     for p in model.parameters())}


def tp_serve_full(torch, kernels, mesh, rank, cfg_row):
    """Phase 3j (b), one rank: phi4-mini-3.8b at full width and depth, bf16,
    sharded at tp=2; prompts from walks of the scale-22 text."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    dev = mesh_device(mesh)
    tp = mesh.mesh.shape[1]
    cfg = get_config(SERVE_ARCH)
    prompts, load_s, lc = tp_prompts(torch, kernels, cfg, cfg_row["path"],
                                     dev)
    need(lc, LOAD_KERNELS, f"tp serve rank {rank}: the text load")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, SEED, tp=tp, device=dev)
    if cfg_row["backend"] == "nccl":
        for p in model.parameters():
            dist.broadcast(p.detach(), src=0)
    tpar.shard_model(model, cfg, mesh)
    free_card(torch)
    row = tp_decode_run(torch, model, cfg, prompts, tp)
    row.update(text_load_s=load_s, launches=lc,
               prompts=prompts.cpu().tolist(),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del model
    free_card(torch)
    return row


def tp_train_full(torch, mesh, run, backend):
    """Phase 3j (c) (``layers`` deep) and ``--cards 4``'s training runs,
    one rank: phi4-mini-3.8b at full width from the seed's f32 weights,
    ``steps`` local-accumulation steps (f32, or ZeRO-1) on one fixed
    batch: losses, gradient norms, step ms, peak memory, the state's bytes
    a rank."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import (make_local_accum_train_step,
                                        make_zero1_local_state)
    dev = mesh_device(mesh)
    n_dp, tp = mesh.mesh.shape
    cfg = get_config(TRAIN_ARCH)
    if run.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    zero1 = run.get("zero1", False)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, SEED, tp=tp, device=dev, dtype=torch.float32)
    if backend == "nccl":
        for p in model.parameters():
            dist.broadcast(p.detach(), src=0)
    tpar.shard_model(model, cfg, mesh)
    free_card(torch)
    state = make_zero1_local_state(model, n_dp, tp, mesh=mesh) if zero1 \
        else init_state(model)
    step = make_local_accum_train_step(
        cfg, OptimizerConfig(**DP_FULL_OC), mesh, remat_policy="full",
        accum_steps=1, zero1=zero1)
    batch = synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, device=dev)
    losses, norms, ms, coll = [], [], [], {}
    steps = run.get("steps", 1)
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_bytes(coll if i == steps - 1 else {}):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
    local = (lambda t: t.to_local() if hasattr(t, "to_local") else t)
    row = {"layers": cfg.num_layers, "mesh": [n_dp, tp], "zero1": zero1,
           "losses": losses, "grad_norms": norms, "step_ms": ms,
           "collectives_last_step": coll,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes_rank": sum(p.numel() * 4
                                   for p in state.params.parameters()),
           "moment_bytes_rank": sum(local(t).numel() * 4 for t in
                                    list(state.mu.values())
                                    + list(state.nu.values()))}
    require(all(np.isfinite(losses)), f"tp train {row}: finite losses")
    del state, model, step
    free_card(torch)
    return row


def tp_rank(cfg_path) -> int:
    """One rank of a phase-3j world (``--tp-rank``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.scripts import local_world
    with open(cfg_path) as f:
        cfg = json.load(f)
    torch.cuda.set_device(int(os.environ["RANK"])
                          % torch.cuda.device_count())
    mesh, rank, world = local_world.join(cfg["backend"], "cuda",
                                         cfg["mesh"], ("data", "model"))
    try:
        rows = {}
        for mode in cfg["modes"]:
            if mode == "reduced":
                rows[mode] = tp_reduced_checks(torch, mesh, rank)
            elif mode == "steps":
                rows[mode] = tp_step_checks(torch, mesh, rank)
            elif mode == "serve":
                rows[mode] = tp_serve_full(torch, kernels, mesh, rank, cfg)
            else:
                rows[mode] = tp_train_full(torch, mesh, cfg[mode],
                                           cfg["backend"])
        if cfg.get("then_mesh"):       # --cards: a second mesh in the world
            from torch.distributed.device_mesh import init_device_mesh
            mesh2 = init_device_mesh("cuda", tuple(cfg["then_mesh"]),
                                     mesh_dim_names=("data", "model"))
            for mode in cfg["then_modes"]:
                rows[mode] = tp_train_full(torch, mesh2, cfg[mode],
                                           cfg["backend"])
    finally:
        local_world.leave()
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    return 0


def tp_world(name, mesh, backend, modes, flag="--tp-rank", **extra):
    """A world of ``mesh[0] * mesh[1]`` ranks of this script (``flag``
    picks the rank's function, :func:`tp_rank` by default); returns
    ``(wall seconds, every rank's rows)``."""
    from repro_torch.scripts import local_world
    out = os.path.join(OUT, f"tp_{name}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    cfg = os.path.join(out, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"mesh": list(mesh), "backend": backend, "modes": modes,
                   "out": out, **extra}, f)
    t0 = time.perf_counter()
    runs = local_world.spawn([sys.executable, os.path.abspath(__file__),
                              flag, cfg], mesh[0] * mesh[1],
                             timeout=900, workdir=out)
    wall = time.perf_counter() - t0
    rows = []
    for k, run in enumerate(runs):
        require(run.returncode == 0, f"tp {name} over {backend}: rank {k} "
                f"exited {run.returncode}:\n{run.stdout[-3000:]}"
                f"{run.stderr[-3000:]}")
        with open(os.path.join(out, f"rank{k}.json")) as f:
            rows.append(json.load(f))
    shutil.rmtree(out, ignore_errors=True)
    return wall, rows


def check_tp_reduced(reduced, steps):
    """Phase 3j (a)'s requirements over the two worlds' rows."""
    for k, r in enumerate(reduced):
        for arch, a in r["reduced"].items():
            require(abs(a["loss"] - a["unsharded_loss"])
                    <= TP_LOSS_RTOL * abs(a["unsharded_loss"])
                    and a["grad_err"] <= TP_GRAD_TOL
                    and a["logits_past_tol"] <= 0,
                    f"tp_reduced {arch} rank {k}: sharded against unsharded "
                    f"({a})")
    for k, r in enumerate(steps):
        for mode, m in r["steps"].items():
            require(abs(m["loss"] - m["single_loss"])
                    <= CARD_LOSS_RTOL * abs(m["single_loss"])
                    and abs(m["grad_norm"] - m["single_grad_norm"])
                    <= CARD_GNORM_RTOL * m["single_grad_norm"]
                    and m.get("params_past_tol", 0) <= 0,
                    f"tp (2, 2) rank {k} {mode}: against make_train_step "
                    f"({m})")


def check_tp_streams(got, want):
    """Greedy token streams of the sharded and the unsharded run (one
    token from the prefill, then one a step): row by row equal up to the
    first token whose top-2 margin in the unsharded run is within
    ``MARGIN_TOL`` (from there the rows may part).  Returns the tokens
    compared."""
    compared = 0
    for row in range(len(want["tokens"][0])):
        for a, b, m in zip(got["tokens"], want["tokens"], want["margins"]):
            if m[row] <= MARGIN_TOL:
                break
            require(a[row] == b[row], f"tp serve row {row}: token {a[row]} "
                    f"!= {b[row]} with a margin of {m[row]}")
            compared += 1
    return compared


def phase_tp(torch, kernels, text_path, report):
    """Tensor-parallel execution on the card (phase 3j): (a) reduced parity
    in a (1, 2) and a (2, 2) world over gloo on this card; (b) phi4-mini-3.8b
    served at full width and depth at tp=2 against tp=1; (c) trained at
    full width, ``TP_TRAIN_LAYERS`` deep, at tp=2 against tp=1.  Returns
    the loader's launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    t_phase = time.perf_counter()
    free_card(torch)
    row = {}
    report["tp"] = row
    wall_a, rows_a = tp_world("reduced", (1, 2), "gloo", ["reduced"])
    wall_s, rows_s = tp_world("steps", (2, 2), "gloo", ["steps"])
    check_tp_reduced(rows_a, rows_s)
    row["reduced"] = {"what": "a test of the tp arithmetic on one card "
                      "over gloo, not a deployment", "world_s": wall_a,
                      "steps_world_s": wall_s, "ranks": rows_a,
                      "steps": rows_s}
    say(json.dumps({"tp_reduced": row["reduced"]}))

    dev = torch.device("cuda", 0)
    wall_b, rows_b = tp_world("serve", (1, 2), "gloo", ["serve"],
                              path=text_path)
    cfg = get_config(SERVE_ARCH)
    prompts = torch.tensor(rows_b[0]["serve"]["prompts"], dtype=torch.int32,
                           device=dev)
    for r in rows_b[1:]:
        require(r["serve"]["prompts"] == rows_b[0]["serve"]["prompts"] and
                r["serve"]["tokens"] == rows_b[0]["serve"]["tokens"],
                "tp serve: every rank's prompts and tokens equal")
    model = init_params(cfg, SEED, tp=2, device=dev)
    want = tp_decode_run(torch, model, cfg, prompts, 2)
    del model
    free_card(torch)
    compared = check_tp_streams(rows_b[0]["serve"], want)
    row["serve"] = {"what": "tp=2 over gloo, both ranks on this card",
                    "world_s": wall_b,
                    "ranks": [{k: v for k, v in r["serve"].items()
                               if k not in ("prompts", "margins")}
                              for r in rows_b],
                    "tp1": {k: v for k, v in want.items()
                            if k not in ("margins",)},
                    "tokens_compared": compared}
    say(json.dumps({"tp_serve": row["serve"]}))

    train = {"layers": TP_TRAIN_LAYERS, "steps": 1}
    wall_c, rows_c = tp_world("train", (1, 2), "gloo", ["train"],
                              train=train)
    cfg4 = dataclasses.replace(get_config(TRAIN_ARCH),
                               num_layers=TP_TRAIN_LAYERS)
    state = init_state(init_params(cfg4, SEED, tp=2, device=dev,
                                   dtype=torch.float32))
    step = make_train_step(cfg4, OptimizerConfig(**DP_FULL_OC),
                           remat_policy="full")
    state, m = step(state, synthetic_batch(cfg4, TRAIN_BATCH, TRAIN_SEQ, 0,
                                           device=dev))
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    del state, step
    free_card(torch)
    got = rows_c[0]["train"]
    require(abs(got["losses"][0] - loss) <= TP_LOSS_RTOL * abs(loss)
            and abs(got["grad_norms"][0] - gnorm) <= TP_GNORM_RTOL * gnorm,
            f"tp train: tp=2 loss {got['losses'][0]} / grad norm "
            f"{got['grad_norms'][0]} against tp=1's {loss} / {gnorm}")
    row["train"] = {"world_s": wall_c, "ranks": [r["train"] for r in rows_c],
                    "tp1_loss": loss, "tp1_grad_norm": gnorm}
    say(json.dumps({"tp_train": row["train"]}))
    row["phase_s"] = time.perf_counter() - t_phase
    say("phase 3j: tensor-parallel execution (10 reduced archs at tp=2, "
        "(2, 2) steps, phi4-mini-3.8b served and trained at tp=2) checks "
        "out on the card")
    return {f"tp serve rank {k}: the text load for the prompts":
            r["serve"]["launches"] for k, r in enumerate(rows_b)}


def tp_across_cards(torch, cards, path22):
    """``--cards N``'s tensor-parallel world: N ranks over NCCL, one card
    each: phi4-mini-3.8b at full width and depth decoded at tp=N and
    trained with the f32 step on (1, N), then the ZeRO-1 step on (N/2,
    2)."""
    full = {"steps": 2}
    wall, rows = tp_world(
        "cards", (1, cards), "nccl", ["serve", "train"], path=path22,
        train=full, then_mesh=[cards // 2, 2], then_modes=["zero1"],
        zero1=dict(full, zero1=True))
    for mode in ("train", "zero1"):
        require(all(r[mode]["losses"] == rows[0][mode]["losses"]
                    for r in rows), f"--cards {cards} tp {mode}: the "
                f"losses equal on every rank")
    require(all(r["serve"]["tokens"] == rows[0]["serve"]["tokens"]
                for r in rows), f"--cards {cards} tp serve: the tokens "
            f"equal on every rank")
    return {"world_s": wall,
            "ranks": [{k: ({kk: vv for kk, vv in v.items()
                            if kk not in ("prompts", "margins")}
                           if k == "serve" else v) for k, v in r.items()}
                      for r in rows]}


# ---- phase 3k: FSDP execution -------------------------------------------------

FSDP_ARCH = "mixtral-8x22b"
FSDP_LAYERS = 1           # full width, 1 of 56 layers (module docstring)
FSDP_CARDS_LAYERS = 4     # --cards: 4 of 56
FSDP_STEPS = 2            # the second runs on the f32 moments of the first
FSDP_OC = dict(lr=3e-5, warmup_steps=0, decay_steps=100)
FSDP_REDUCED_OC = dict(lr=1e-4, warmup_steps=0, decay_steps=50)
FSDP_REDUCED_BATCH, FSDP_REDUCED_SEQ = 4, 16   # MoE groups span the ranks
FSDP_REDUCED_ACCUM = 2


def local_shape(model, name, placements, sizes):
    """A parameter's piece on a rank by its placements: the whole shape
    with each dim a mesh axis shards divided by that axis's size."""
    from repro_torch.distributed.sharding import whole_shape
    shape = list(whole_shape(model, name))
    for size, pl in zip(sizes, placements):
        if pl.is_shard():
            shape[pl.dim] //= size
    return shape


def fsdp_piece_errors(model, cfg, mesh):
    """The parameters whose piece on this rank has another shape than the
    rules give at ``fsdp=True``."""
    from repro_torch.distributed.sharding import param_placements
    pl = param_placements(model, cfg, mesh, fsdp=True)
    sizes = list(mesh.mesh.shape)
    return [name for name, p in model.named_parameters()
            if list(p.shape) != local_shape(model, name, pl[name], sizes)]


def fsdp_moment_err(torch, model, mu, single_mu):
    """The largest difference of the first step's moments (``(1 - b1)``
    times the gradient), whole, from the single-card run's, over each
    leaf's largest magnitude."""
    from repro_torch.checkpoint.io import _whole
    from repro_torch.distributed import tensor_parallel as tpar
    err = 0.0
    for name, m in mu.items():
        w = _whole(m) if hasattr(m, "to_local") else \
            tpar.whole_of(model, name, m)
        ref = single_mu[name].float()
        err = max(err, float((w.float() - ref).abs().max()
                             / ref.abs().max().clamp_min(1e-30)))
    return err


def fsdp_reduced_checks(torch, mesh, rank, serve):
    """Phase 3k (a), one rank of a gloo world on one card: every reduced
    arch from ``init_params(cfg, SEED, tp)`` at ``fsdp=True`` (a bf16
    state for ``BF16_STATE_ARCHS``), ``FSDP_STEPS`` steps of the mesh step
    against the single-card step of the same parameters; with ``serve``
    also the prefill and greedy decode against the unsharded run."""
    import copy
    from repro_torch.configs import BF16_STATE_ARCHS, reduced_config
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    dev = mesh_device(mesh)
    tp = mesh.mesh.shape[1]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    oc = OptimizerConfig(**FSDP_REDUCED_OC)
    out = {}
    for arch in TP_ARCHS:
        cfg = reduced_config(arch)
        dtype = torch.bfloat16 if arch in BF16_STATE_ARCHS else None
        base = init_params(cfg, SEED, tp=tp, device=dev, dtype=torch.float32)
        batch = synthetic_batch(cfg, FSDP_REDUCED_BATCH, FSDP_REDUCED_SEQ, 0,
                                device=dev)
        one = init_state(copy.deepcopy(base), dtype=dtype)
        single = make_train_step(cfg, oc, accum_steps=FSDP_REDUCED_ACCUM)
        model = tpar.shard_model(base, cfg, mesh, fsdp=True)
        bad = fsdp_piece_errors(model, cfg, mesh)
        require(not bad, f"fsdp {arch} rank {rank}: pieces of other shapes "
                f"than the rules' ({bad[:4]})")
        state = init_state(model, dtype=dtype, mesh=mesh)
        step = make_train_step(cfg, oc, accum_steps=FSDP_REDUCED_ACCUM,
                               mesh=mesh)
        row = {"losses": [], "single_losses": [], "grad_norms": [],
               "single_grad_norms": [], "moment_dtypes": []}
        for i in range(FSDP_STEPS):
            state, m = step(state, batch)
            one, m1 = single(one, batch)
            if i == 0:
                row["grad_err"] = fsdp_moment_err(torch, model, state.mu,
                                                  one.mu)
            row["losses"].append(float(m["loss"]))
            row["single_losses"].append(float(m1["loss"]))
            row["grad_norms"].append(float(m["grad_norm"]))
            row["single_grad_norms"].append(float(m1["grad_norm"]))
            row["moment_dtypes"].append(sorted({
                str((v.to_local() if hasattr(v, "to_local") else v).dtype)
                for v in state.mu.values()}))
        row["param_bytes_rank"] = sum(p.numel() * p.element_size()
                                      for p in model.parameters())
        del state, one, model, base
        if serve:
            row["serve"] = fsdp_reduced_serve(torch, cfg, mesh, batch)
        out[arch] = row
    return out


def fsdp_reduced_serve(torch, cfg, mesh, batch):
    """Prefill and ``TP_REDUCED_STEPS`` greedy steps of the bf16 serving
    model at ``fsdp=True`` (the batch split over the data axis) and
    unsharded: both token streams and the unsharded run's top-2 margins."""
    import copy
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    dev = mesh_device(mesh)
    tp = mesh.mesh.shape[1]
    base = init_params(cfg, SEED, tp=tp, device=dev)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    runs = {}
    for tag, model, m in (("whole", copy.deepcopy(base), None),
                          ("fsdp", tpar.shard_model(base, cfg, mesh,
                                                    fsdp=True), mesh)):
        prefill = make_prefill_step(cfg, TP_REDUCED_MAX, tp=tp, mesh=m)
        decode = make_decode_step(cfg, TP_REDUCED_MAX, tp=tp, mesh=m)
        lg, caches = prefill(model, prompt)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        toks, margins = [tok.cpu().tolist()], []
        for i in range(TP_REDUCED_STEPS):
            top = torch.topk(lg.float(), 2, dim=-1).values
            margins.append((top[:, 0] - top[:, 1]).cpu().tolist())
            pos = torch.full((tok.shape[0],), FSDP_REDUCED_SEQ + i,
                             dtype=torch.int32, device=dev)
            tok, lg, caches = decode(model, caches, {"token": tok,
                                                     "pos": pos})
            toks.append(tok.cpu().tolist())
        top = torch.topk(lg.float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).cpu().tolist())
        runs[tag] = {"tokens": toks, "margins": margins,
                     "cache_rows": next(iter(caches[0].values())).shape[0]}
    return {"tokens": runs["fsdp"]["tokens"],
            "whole_tokens": runs["whole"]["tokens"],
            "margins": runs["whole"]["margins"],
            "cache_rows": runs["fsdp"]["cache_rows"],
            "equal": runs["fsdp"]["tokens"] == runs["whole"]["tokens"]}


def fsdp_full(torch, kernels, mesh, rank, cfg_row, layers):
    """Phase 3k (b) and ``--cards``' runs, one rank: mixtral-8x22b at full
    width, ``layers`` deep, sharded by the reference's defaults
    (``FSDP_ARCHS``, ``BF16_STATE_ARCHS``), ``FSDP_STEPS`` steps of the
    mesh step on a walk batch of the scale-22 text (its load counted):
    losses, gradient norms, step ms, the data axis's all-gathers and
    reduce-scatters a step, state bytes a rank, peak memory."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import BF16_STATE_ARCHS, FSDP_ARCHS, get_config
    from repro_torch.data.pipeline import graph_walk_source
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    dev = mesh_device(mesh)
    cfg = dataclasses.replace(get_config(FSDP_ARCH), num_layers=layers)
    fsdp = cfg.name in FSDP_ARCHS
    dtype = torch.bfloat16 if cfg.name in BF16_STATE_ARCHS else None
    source = graph_walk_source(cfg_row["path"], cfg, TRAIN_BATCH, TRAIN_SEQ,
                               device=dev)
    batch, load_s, lc = counted(torch, kernels, lambda: source(0))
    need(lc, LOAD_KERNELS, f"fsdp rank {rank}: the text load")
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    # the matrices drawn in f32 and rounded to bf16, as the reference's
    # bf16 state casts its f32 init
    model = init_params(cfg, SEED, device=dev)
    if cfg_row["backend"] == "nccl":
        for p in model.parameters():
            dist.broadcast(p.detach(), src=0)
    whole_bytes = sum(p.numel() * 2 for p in model.parameters())
    tpar.shard_model(model, cfg, mesh, fsdp=fsdp)
    free_card(torch)
    state = init_state(model, dtype=dtype, mesh=mesh)
    step = make_train_step(cfg, OptimizerConfig(**FSDP_OC),
                           remat_policy="full", mesh=mesh)
    local = (lambda t: t.to_local() if hasattr(t, "to_local") else t)
    losses, norms, ms, colls, dtypes = [], [], [], [], []
    for i in range(FSDP_STEPS):
        coll = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_bytes(coll):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
        colls.append(coll)
        dtypes.append(sorted({str(local(v).dtype)
                              for v in state.mu.values()}))
    params = sum(p.numel() for p in state.params.parameters())
    row = {"layers": layers, "mesh": list(mesh.mesh.shape), "fsdp": fsdp,
           "param_dtype": str(next(state.params.parameters()).dtype),
           "losses": losses, "grad_norms": norms, "step_ms": ms,
           "collectives": colls, "moment_dtypes": dtypes,
           "text_load_s": load_s, "launches": lc,
           "whole_param_bytes": whole_bytes,
           "param_bytes_rank": sum(p.numel() * p.element_size()
                                   for p in state.params.parameters()),
           "grad_bytes_rank": sum(p.numel() * p.element_size()
                                  for p in state.params.parameters()),
           "moment_bytes_rank": sum(local(t).numel() * local(t).element_size()
                                    for t in list(state.mu.values())
                                    + list(state.nu.values())),
           "params_rank": params,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    row["state_bytes_rank"] = row["param_bytes_rank"] \
        + row["grad_bytes_rank"] + row["moment_bytes_rank"]
    require(all(np.isfinite(losses)), f"fsdp {row['mesh']} rank {rank}: "
            f"finite losses ({losses})")
    del state, model, step, batch, source
    free_card(torch)
    return row


def fsdp_unsharded(torch, text_path, layers):
    """Phase 3k (b)'s comparison, in this process once the world is gone:
    the same model, state and walk batch through the single-card
    ``make_train_step``: losses, gradient norms, step ms, peak memory."""
    import dataclasses
    from repro_torch.configs import BF16_STATE_ARCHS, get_config
    from repro_torch.data.pipeline import graph_walk_source
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(FSDP_ARCH), num_layers=layers)
    dtype = torch.bfloat16 if cfg.name in BF16_STATE_ARCHS else None
    batch = graph_walk_source(text_path, cfg, TRAIN_BATCH, TRAIN_SEQ,
                              device=dev)(0)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    state = init_state(init_params(cfg, SEED, device=dev), dtype=dtype)
    step = make_train_step(cfg, OptimizerConfig(**FSDP_OC),
                           remat_policy="full")
    losses, norms, ms = [], [], []
    for _ in range(FSDP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
    row = {"losses": losses, "grad_norms": norms, "step_ms": ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del state, step, batch
    free_card(torch)
    return row


def fsdp_rank(cfg_path) -> int:
    """One rank of a phase-3k world (``--fsdp-rank``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.scripts import local_world
    with open(cfg_path) as f:
        cfg = json.load(f)
    torch.cuda.set_device(int(os.environ["RANK"])
                          % torch.cuda.device_count())
    mesh, rank, world = local_world.join(cfg["backend"], "cuda",
                                         cfg["mesh"], ("data", "model"))
    try:
        rows = {}
        for mode in cfg["modes"]:
            if mode == "reduced":
                rows[mode] = fsdp_reduced_checks(torch, mesh, rank,
                                                 cfg.get("serve", False))
            else:
                rows[mode] = fsdp_full(torch, kernels, mesh, rank, cfg,
                                       cfg["layers"])
        if cfg.get("then_mesh"):       # --cards: a second mesh in the world
            from torch.distributed.device_mesh import init_device_mesh
            mesh2 = init_device_mesh("cuda", tuple(cfg["then_mesh"]),
                                     mesh_dim_names=("data", "model"))
            rows["then"] = fsdp_full(torch, kernels, mesh2, rank, cfg,
                                     cfg["layers"])
    finally:
        local_world.leave()
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    return 0


def check_fsdp_reduced(rows, world):
    """Phase 3k (a)'s requirements over a world's rows: each step's loss
    and gradient norm, the first step's gradients (its moments), the
    moments f32 after the first step, and the tokens where the unsharded
    run's top-2 margin exceeds ``MARGIN_TOL``."""
    for k, r in enumerate(rows):
        for arch, a in r["reduced"].items():
            what = f"fsdp {world} {arch} rank {k}"
            require(abs(a["losses"][0] - a["single_losses"][0])
                    <= TP_LOSS_RTOL * abs(a["single_losses"][0])
                    and abs(a["losses"][1] - a["single_losses"][1])
                    <= CARD_LOSS_RTOL * abs(a["single_losses"][1])
                    and all(abs(x - y) <= TP_GNORM_RTOL * y for x, y in
                            zip(a["grad_norms"], a["single_grad_norms"]))
                    and a["grad_err"] <= TP_GRAD_TOL,
                    f"{what}: against the single-card step ({a})")
            require(all(d == ["torch.float32"]
                        for d in a["moment_dtypes"]),
                    f"{what}: the moments f32 after each step "
                    f"({a['moment_dtypes']})")
            if "serve" in a:
                s = a["serve"]
                for row in range(len(s["whole_tokens"][0])):
                    for x, y, mg in zip(s["tokens"], s["whole_tokens"],
                                        s["margins"]):
                        if mg[row] <= MARGIN_TOL:
                            break
                        require(x[row] == y[row], f"{what}: token {x[row]} "
                                f"!= {y[row]} at a margin of {mg[row]}")


def fsdp_world(name, mesh, backend, modes, **extra):
    """A world of ``mesh[0] * mesh[1]`` ranks of this script
    (:func:`fsdp_rank`)."""
    return tp_world(name, mesh, backend, modes, flag="--fsdp-rank", **extra)


def phase_fsdp(torch, kernels, text_path, report):
    """FSDP execution on the card (phase 3k): (a) the reduced archs at
    ``(2, 1)`` and ``(2, 2)`` in gloo worlds on this card against the
    single-card step, the reduced serving at ``(2, 1)``; (b) mixtral-8x22b
    at full width, ``FSDP_LAYERS`` deep, in a gloo world of two.  Returns
    the loader's launch counts."""
    t_phase = time.perf_counter()
    free_card(torch)
    row = {}
    report["fsdp"] = row
    reduced = {}
    for name, mesh in (("(2, 1)", (2, 1)), ("(2, 2)", (2, 2))):
        wall, rows = fsdp_world(f"reduced{mesh[1]}", mesh, "gloo",
                                ["reduced"], serve=mesh == (2, 1))
        check_fsdp_reduced(rows, name)
        reduced[name] = {"world_s": wall, "ranks": rows}
    row["reduced"] = dict(reduced, what="a test of the FSDP arithmetic on "
                          "one card over gloo, not a deployment")
    say(json.dumps({"fsdp_reduced": {
        k: {"world_s": v["world_s"], "rank0": {
            a: {kk: vv for kk, vv in r.items() if kk != "serve"}
            for a, r in v["ranks"][0]["reduced"].items()}}
        for k, v in reduced.items()}}))

    wall, rows = fsdp_world("full", (2, 1), "gloo", ["full"],
                            path=text_path, layers=FSDP_LAYERS)
    for r in rows[1:]:
        require(r["full"]["losses"] == rows[0]["full"]["losses"],
                "fsdp full: every rank's losses equal")
    whole = fsdp_unsharded(torch, text_path, FSDP_LAYERS)
    got = rows[0]["full"]["losses"]
    require(abs(got[0] - whole["losses"][0])
            <= TP_LOSS_RTOL * abs(whole["losses"][0]),
            f"fsdp full: step 0's loss {got[0]} against the unsharded "
            f"step's {whole['losses'][0]}")
    row["full"] = {"what": "fsdp over gloo, both ranks on this card: its "
                   "step times show gloo's host copies, not FSDP",
                   "world_s": wall, "ranks": [r["full"] for r in rows],
                   "unsharded": whole}
    say(json.dumps({"fsdp_full": row["full"]}))
    row["phase_s"] = time.perf_counter() - t_phase
    say("phase 3k: FSDP execution (10 reduced archs at (2, 1) and (2, 2), "
        "mixtral-8x22b at full width with its bf16 state) checks out on "
        "the card")
    return {f"fsdp rank {k}: the text load for its walks":
            r["full"]["launches"] for k, r in enumerate(rows)}


def fsdp_across_cards(torch, cards, path22):
    """``--cards N``'s FSDP world: N ranks over NCCL, one card each:
    mixtral-8x22b at full width, ``FSDP_CARDS_LAYERS`` deep, at ``(N,
    1)``, then at ``(N/2, 2)``."""
    wall, rows = fsdp_world("cards", (cards, 1), "nccl", ["full"],
                            path=path22, layers=FSDP_CARDS_LAYERS,
                            then_mesh=[cards // 2, 2])
    for mode in ("full", "then"):
        require(all(r[mode]["losses"] == rows[0][mode]["losses"]
                    for r in rows), f"--cards {cards} fsdp {mode}: the "
                f"losses equal on every rank")
    return {"world_s": wall, "ranks": rows}


# ---------------------------------------------------------------------------
# phase 3l: the launch tooling, the local step at fsdp=True, the examples
# ---------------------------------------------------------------------------

# the dry run's cells on the production meshes (fake cuda tensors): the
# reference's defaults (FSDP and the bf16 state of the MoE), the training
# cells cut to one microbatch (the --all dry run keeps default_accum)
LAUNCH_CELLS = (("mixtral-8x22b", "train_4k", False, {"accum": 1}),
                ("phi4-mini-3.8b", "train_4k", False,
                 {"step_mode": "local_zero1", "accum": 1}),
                ("phi4-mini-3.8b", "decode_32k", True, {}),
                ("falcon-mamba-7b", "long_500k", True, {}))
LOCAL_ARCH, LOCAL_LAYERS = "phi4-mini-3.8b", 4    # full width, 4 of 32
LOCAL_CARDS_ARCH, LOCAL_CARDS_LAYERS = "mixtral-8x22b", 1   # 1 of 56
LOCAL_STEPS, LOCAL_BATCH, LOCAL_SEQ = 2, 4, 128
LOCAL_OC = dict(lr=3e-5, warmup_steps=0, decay_steps=100)
# train_lm's own schedule warms up over 20 steps: at 20 steps its loss
# has not moved yet (5.7366 -> 5.7375 on the CPU), at 60 it falls
EXAMPLE_TRAIN_STEPS = 60


def launch_cells_start():
    """Phase 3l (b), started in worker processes (the dry run is host
    work): ``dryrun.cell_job`` of each of ``LAUNCH_CELLS`` on fake
    ``cuda`` tensors.  Returns ``(pool, futures)``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch import dryrun
    pool = ProcessPoolExecutor(len(LAUNCH_CELLS), mp_context=multiprocessing
                               .get_context("spawn"))
    futs = [pool.submit(dryrun.cell_job, (arch, shape, mp, dict(
        kw, device="cuda", verbose=False)))
            for arch, shape, mp, kw in LAUNCH_CELLS]
    return pool, futs


def launch_cells_row(pool, futs):
    """Phase 3l (b)'s records, each printed beside its analytic terms."""
    rows = []
    try:
        for f in futs:
            rec = f.result(timeout=600)
            require(rec["status"] == "ok", f"dry run of {rec['arch']} x "
                    f"{rec['shape']} ({rec['mesh']}): {rec}")
            rows.append({k: rec[k] for k in (
                "arch", "shape", "mesh", "chips", "meta", "lower_s",
                "compile_s", "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collective_calls_per_device",
                "memory", "analytic_flops_total",
                "analytic_bytes_per_device", "model_flops")})
            r = rows[-1]
            require(r["flops_per_device"] > 0 and r["memory"]["temp_gb"] > 0,
                    f"dry run of {r['arch']} x {r['shape']}: counted")
            say(json.dumps({"dry_run": {
                "cell": f"{r['arch']} x {r['shape']} ({r['mesh']})",
                "trace_s": r["compile_s"], "flops_per_device":
                r["flops_per_device"], "analytic_flops_per_device":
                r["analytic_flops_total"] / r["chips"],
                "analytic_bytes_per_device": r["analytic_bytes_per_device"],
                "collective_bytes": r["collective_bytes_per_device"],
                "argument_gb": r["memory"]["argument_gb"],
                "temp_gb": r["memory"]["temp_gb"]}}))
    finally:
        pool.shutdown(cancel_futures=True)
    return rows


def launch_examples(torch, kernels, row):
    """Phase 3l (a): the example twins on the card.  Returns the loader's
    launch counts per path."""
    from repro_torch.examples import (distributed_load, quickstart, serve_lm,
                                      train_lm)
    work = os.path.join(OUT, "quickstart")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    got, secs, lc = counted(torch, kernels,
                            lambda: quickstart.run("cuda", work))
    need(lc, LOAD_KERNELS, "quickstart")
    edges = np.loadtxt(os.path.join(work, "web.el"), dtype=np.int64) - 1
    offsets, targets, _ = csr_oracle(edges[:, 0], edges[:, 1], None, got["v"])
    require(np.array_equal(got["csr"].offsets, offsets)
            and np.array_equal(got["csr"].targets, targets),
            "quickstart: its CSR against the numpy oracle")
    shutil.rmtree(work, ignore_errors=True)
    row["quickstart"] = {"s": secs, "launches": lc, "v": got["v"],
                         "e": got["e"]}

    t0 = time.perf_counter()
    require(serve_lm.main(["--device", "cuda"]) == 0, "serve_lm")
    row["serve_lm_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    hist = train_lm.run(train_lm.parse(["--device", "cuda", "--steps",
                                        str(EXAMPLE_TRAIN_STEPS)]))
    losses = [h["loss"] for h in hist]
    require(all(np.isfinite(losses))
            and np.mean(losses[-10:]) < np.mean(losses[:10]),
            f"train_lm: the loss falls ({losses[:3]} .. {losses[-3:]})")
    row["train_lm"] = {"s": time.perf_counter() - t0, "steps": len(losses),
                       "first10": float(np.mean(losses[:10])),
                       "last10": float(np.mean(losses[-10:]))}

    d1, secs, lc1 = counted(torch, kernels, lambda: distributed_load
                            .rank_main("nccl", "cuda"))
    need(lc1, LOAD_KERNELS, "distributed_load, an NCCL world of one")
    row["distributed_load"] = {"nccl_d1_s": secs, "launches": lc1}
    t0 = time.perf_counter()
    require(distributed_load.main(["--device", "cuda", "--world", "2",
                                   "--backend", "gloo"]) == 0,
            "distributed_load, a gloo world of two on this card")
    row["distributed_load"]["gloo_d2_s"] = time.perf_counter() - t0
    say(json.dumps({"examples": row}))
    return {"launch: quickstart": lc,
            "launch: distributed_load (NCCL, d=1)": lc1}


def local_batch(torch, cfg, dev):
    g = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (LOCAL_BATCH, LOCAL_SEQ + 1),
                         generator=g, dtype=torch.int32)
    return {"tokens": toks[:, :-1].contiguous().to(dev),
            "labels": toks[:, 1:].contiguous().to(dev)}


def local_cfg(arch, layers):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers)


def local_runs(torch, mesh, rank, cfg_row):
    """One rank of phase 3l (c) (and of ``--cards``' local step): the
    local-accumulation step at ``fsdp=True`` (``cfg_row["runs"]`` holds
    ``"fsdp"`` and maybe ``"whole"``, ``fsdp=False``) from the seed's
    weights, ``LOCAL_STEPS`` steps, the first under
    ``launch.counters.Recorder``: losses, gradient norms, step ms, the
    recorder's counts and memory, the allocator's peak over the first
    step and the bytes allocated before it."""
    import torch.distributed as dist
    from repro_torch.configs import BF16_STATE_ARCHS
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.collectives import mesh_device
    from repro_torch.distributed.sharding import dp_axes, mesh_axes
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.state import cast_model, init_state
    from repro_torch.train.step import make_local_accum_train_step
    dev = mesh_device(mesh)
    cfg = local_cfg(cfg_row["arch"], cfg_row["layers"])
    dtype = torch.bfloat16 if cfg.name in BF16_STATE_ARCHS else None
    batch = local_batch(torch, cfg, dev)
    out = {}
    for run in cfg_row["runs"]:
        free_card(torch)
        model = init_params(cfg, SEED, device=dev, dtype=torch.float32)
        if cfg_row["backend"] == "nccl":
            for p in model.parameters():
                dist.broadcast(p.detach(), src=0)
        if dtype is not None:
            cast_model(model, dtype)
        tpar.shard_model(model, cfg, mesh, fsdp=run == "fsdp")
        state = init_state(model)
        step = make_local_accum_train_step(
            cfg, OptimizerConfig(**LOCAL_OC), mesh, remat_policy="full",
            batch_axes=dp_axes(mesh_axes(mesh)))
        losses, norms, ms = [], [], []
        r = {}
        for i in range(LOCAL_STEPS):
            torch.cuda.synchronize()
            if i == 0:
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                args = (state, batch)
                (state, m), rec, _ = dryrun.measure(step, args)
                losses.append(float(m["loss"]))
                r.update(dryrun.counts_of(rec),
                         memory=dryrun.memory_of(args, (state, m), rec),
                         allocated_before_bytes=before,
                         peak_bytes=torch.cuda.max_memory_allocated())
                del args, rec
            else:
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            norms.append(float(m["grad_norm"]))
        r.update(losses=losses, grad_norms=norms, step_ms=ms,
                 state_bytes=sum(p.numel() * p.element_size()
                                 for p in state.params.parameters())
                 + sum(t.numel() * t.element_size() for t in
                       list(state.mu.values()) + list(state.nu.values())))
        require(all(np.isfinite(losses)), f"local {run} rank {rank}: "
                f"finite losses ({losses})")
        out[run] = r
        del state, model, step
    free_card(torch)
    return out


def launch_rank(cfg_path) -> int:
    """One rank of a phase-3l world (``--launch-rank``)."""
    import torch
    from repro_torch.scripts import local_world
    with open(cfg_path) as f:
        cfg = json.load(f)
    torch.cuda.set_device(int(os.environ["RANK"])
                          % torch.cuda.device_count())
    mesh, rank, _ = local_world.join(cfg["backend"], "cuda", cfg["mesh"],
                                     ("data", "model"))
    try:
        rows = local_runs(torch, mesh, rank, cfg)
    finally:
        local_world.leave()
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    return 0


def local_fake(torch, arch, layers, mesh_shape, like):
    """The same local step through the dry run in a fake world of
    ``mesh_shape`` (standing for ``like``), on fake ``cuda`` tensors, as
    rank 0."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.shapes import ShapeCase
    with fake_world(mesh_shape[0] * mesh_shape[1], like=like):
        mesh = init_device_mesh("cuda", tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
        return dryrun.measure_cell(
            local_cfg(arch, layers), ShapeCase("smoke", LOCAL_SEQ,
                                               LOCAL_BATCH, "train"),
            mesh, device="cuda", step_mode="local_accum", fsdp=True,
            accum=1, remat_policy="full")


def check_local(rows, fake, what):
    """Every rank's losses equal, the ``fsdp=True`` step's equal to the
    ``fsdp=False`` step's where both ran, and the fake world's
    collectives and FLOPs equal rank 0's."""
    first = rows[0]["fsdp"]
    for k, r in enumerate(rows):
        require(r["fsdp"]["losses"] == first["losses"],
                f"{what}: rank {k}'s losses {r['fsdp']['losses']} equal "
                f"rank 0's {first['losses']}")
        if "whole" in r:
            require(r["fsdp"]["losses"] == r["whole"]["losses"],
                    f"{what}: rank {k}: fsdp=True's losses "
                    f"{r['fsdp']['losses']} equal fsdp=False's "
                    f"{r['whole']['losses']}")
    for key in ("collective_calls_per_device", "collective_bytes_per_device",
                "flops_per_device"):
        require(fake[key] == first[key], f"{what}: the fake world's {key} "
                f"{fake[key]} equal the real world's {first[key]}")


def phase_launch(torch, kernels, report):
    """Phase 3l: (a) the example twins on the card, (b) the dry run of
    ``LAUNCH_CELLS`` (started first, in worker processes), (c) the
    local-accumulation step at ``fsdp=True`` at full width in a gloo world
    of two on this card against ``fsdp=False`` and against a fake world.
    Returns the loader's launch counts per path."""
    t_phase = time.perf_counter()
    free_card(torch)
    row = {}
    report["launch"] = row
    from concurrent.futures import ThreadPoolExecutor
    pool, futs = launch_cells_start()
    t0 = time.perf_counter()
    # (c)'s world (its ranks are processes of their own) beside (a)
    with ThreadPoolExecutor(1) as worlds:
        world = worlds.submit(tp_world, "launch", (2, 1), "gloo", [],
                              flag="--launch-rank", arch=LOCAL_ARCH,
                              layers=LOCAL_LAYERS, runs=["fsdp", "whole"])
        by_path = launch_examples(torch, kernels,
                                  row.setdefault("examples", {}))
        wall, rows = world.result()
    fake = local_fake(torch, LOCAL_ARCH, LOCAL_LAYERS, (2, 1), "gloo")
    check_local(rows, fake, "local step at fsdp=True, (2, 1) over gloo")
    mem = fake["memory"]
    row["local"] = {"what": "phi4-mini-3.8b at full width, 4 of 32 layers, "
                    "both ranks on this card over gloo",
                    "world_s": wall, "s": time.perf_counter() - t0,
                    "ranks": rows, "fake": fake,
                    "fake_argument_plus_temp_bytes":
                    (mem["argument_gb"] + mem["temp_gb"]) * 1e9,
                    "real_peak_bytes": rows[0]["fsdp"]["peak_bytes"]}
    say(json.dumps({"launch_local": {k: v for k, v in row["local"].items()
                                     if k != "ranks"} | {"rank0": rows[0]}}))

    row["dry_run"] = launch_cells_row(pool, futs)
    row["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 3l: the examples, the dry run of {len(LAUNCH_CELLS)} cells "
        f"and the local step at fsdp=True check out on the card "
        f"({row['phase_s']:.1f}s)")
    return by_path


def launch_across_cards(torch, cards):
    """``--cards N``'s local step at ``fsdp=True``: mixtral-8x22b at full
    width, ``LOCAL_CARDS_LAYERS`` deep, its bf16 state, at ``(N, 1)`` over
    NCCL, one rank a card, against a fake ``(N, 1)`` world that stands
    for NCCL."""
    wall, rows = tp_world("launch_cards", (cards, 1), "nccl", [],
                          flag="--launch-rank", arch=LOCAL_CARDS_ARCH,
                          layers=LOCAL_CARDS_LAYERS, runs=["fsdp"])
    fake = local_fake(torch, LOCAL_CARDS_ARCH, LOCAL_CARDS_LAYERS,
                      (cards, 1), "nccl")
    check_local(rows, fake, f"--cards {cards} local step at fsdp=True")
    return {"world_s": wall, "ranks": rows, "fake": fake}


# ---------------------------------------------------------------------------
# phase 3m: the paper's comparisons -- GVEL's host engines and baselines
# ---------------------------------------------------------------------------

HOST_SCALE, NAIVE_SCALE = 20, 18   # phase 3m's file; the naive loop's (cut)
HOST_MAX_WORKERS = 32


CPUINFO_KEYS = ("model name", "vendor_id", "cpu family", "model", "stepping",
                "cpu MHz", "cache size")


def host_machine() -> dict:
    """The host's CPU model (the first processor's ``/proc/cpuinfo`` fields
    that name it: a virtual machine may say "unknown" for the model name)
    and the cores this process may run on."""
    cpu = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            if key.strip() in CPUINFO_KEYS:
                cpu[key.strip()] = value.strip()
    return {"cpu": cpu, "cores": len(os.sched_getaffinity(0)),
            "cpu_count": os.cpu_count()}


def smi_line():
    """``nvidia-smi --query-gpu=name,power.limit``'s first line, or None."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else None


def wall_s(fn):
    """``(fn(), seconds)`` on the host's clock (host work, no card)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def check_el(el, src, dst, v, what):
    """A CPU edge list bitwise against the file's generated edges."""
    require(el.src.device.type == "cpu" and int(el.num_edges) == len(src)
            and int(el.num_vertices) == v
            and np.array_equal(el.src.numpy(), src)
            and np.array_equal(el.dst.numpy(), dst),
            f"{what}: the edge list equals the oracle's edges")


def phase_host_engines(torch, repro_torch, kernels, report):
    """Phase 3m: the paper's comparisons on the card's machine.  On an RMAT
    scale-20 text file (16,777,216 edges, Graph500's parameters, phase 3c's
    file): GVEL on the card (``open_graph(p).csr()``, the second load
    timed, its launches counted); GVEL on the host, the ``threads`` engine
    at 1, 2, 4, ... workers up to this process's cores (at most
    ``HOST_MAX_WORKERS``), for the edge list alone and for ``csr()``, and
    ``csr_staged_np`` (rho = max(4, workers)) at the same counts; the
    ``numpy`` engine and its host build; PIGO (``read_edgelist_pigo`` then
    ``csr_pigo``); ``read_edgelist_loadtxt``; and the Hornet / Gunrock
    analogue (``read_edgelist_naive`` then ``csr_pigo``) at scale 18 only
    (cut: its Python loop over 16.7 M lines would take the phase's whole
    budget; it is compared by edges/s).  Then one edge list, both builds:
    the ``threads`` engine's edge list loaded onto the card, built there
    by ``convert_to_csr`` (the histogram and the scan must launch), equal
    to the host build.  Every product is held bitwise against the numpy
    oracle of its file.  Host work is timed with ``device="cpu"`` on the
    host's clock, one run each (files in the page cache).  Returns the
    loader's launch counts per path."""
    from repro_torch.core import baselines, build, convert_to_csr
    t_phase = time.perf_counter()
    free_card(torch)
    cpu = {"device": "cpu"}
    p20, s20, d20, _ = make_graph("rmat20.el", HOST_SCALE, False, False,
                                  SEED + 30)
    p18, s18, d18, _ = make_graph("rmat18n.el", NAIVE_SCALE, False, False,
                                  SEED + 50)
    v20 = int(max(s20.max(), d20.max())) + 1
    v18 = int(max(s18.max(), d18.max())) + 1
    oracle20 = csr_oracle(s20, d20, None, v20)
    oracle18 = csr_oracle(s18, d18, None, v18)
    machine = host_machine()
    counts = [1 << k for k in range(6)
              if 1 << k <= min(machine["cores"], HOST_MAX_WORKERS)]
    loaders = {}
    launches = {}

    def keep(name, seconds, edges, what):
        loaders[name] = {"what": what, "seconds": seconds, "edges": edges,
                         "edges_per_s": edges / seconds}

    # GVEL on the card: the second load of the file is timed
    for turn in (1, 2):
        csr, sec, lc = counted(torch, kernels,
                               lambda: repro_torch.open_graph(p20).csr())
        need(lc, LOAD_KERNELS, f"3m card load {turn}")
        check_csr(csr, oracle20, False, f"3m card load {turn}")
        del csr
    launches["host engines: card load"] = lc
    keep("gvel_card_csr", sec, len(s20),
         "open_graph(p).csr() on the card, second load")

    # GVEL on the host: the threads engine and csr_staged_np by workers
    host = None
    for w in counts:
        el, sec = wall_s(lambda: repro_torch.load_edgelist(
            p20, engine="threads", num_workers=w, **cpu))
        check_el(el, s20, d20, v20, f"threads w={w}")
        keep(f"threads_w{w}_edgelist", sec, len(s20),
             f"load_edgelist(engine='threads', num_workers={w})")
        host, sec = wall_s(lambda: repro_torch.open_graph(
            p20, engine="threads", num_workers=w, **cpu).csr())
        check_csr(host, oracle20, False, f"threads w={w} csr")
        keep(f"threads_w{w}_csr", sec, len(s20),
             f"open_graph(engine='threads', num_workers={w}).csr()")
        src, dst = el.src.numpy(), el.dst.numpy()
        c, sec = wall_s(lambda: build.csr_staged_np(
            src, dst, None, v20, rho=max(4, w), num_workers=w))
        check_csr(c, oracle20, False, f"csr_staged_np w={w}")
        keep(f"csr_staged_np_w{w}", sec, len(s20),
             f"csr_staged_np(rho={max(4, w)}, num_workers={w}) of the "
             f"edge list")
        del el, c, src, dst

    # the numpy engine, then its host build
    el, t_el = wall_s(lambda: repro_torch.load_edgelist(p20, engine="numpy",
                                                        **cpu))
    check_el(el, s20, d20, v20, "numpy engine")
    c, t_build = wall_s(lambda: convert_to_csr(el, engine="numpy"))
    check_csr(c, oracle20, False, "numpy engine + convert_to_csr(numpy)")
    keep("numpy_edgelist", t_el, len(s20), "load_edgelist(engine='numpy')")
    keep("numpy_csr", t_el + t_build, len(s20),
         "load_edgelist(engine='numpy') + convert_to_csr(engine='numpy')")

    # PIGO's two passes, then its single-stage CSR
    el, t_el = wall_s(lambda: baselines.read_edgelist_pigo(p20, **cpu))
    check_el(el, s20, d20, v20, "PIGO")
    c, t_build = wall_s(lambda: baselines.csr_pigo(el, **cpu))
    check_csr(c, oracle20, False, "PIGO + csr_pigo")
    keep("pigo_edgelist", t_el, len(s20), "read_edgelist_pigo (8 parts)")
    keep("pigo_csr", t_el + t_build, len(s20),
         "read_edgelist_pigo + csr_pigo")

    el, sec = wall_s(lambda: baselines.read_edgelist_loadtxt(p20, **cpu))
    check_el(el, s20, d20, v20, "loadtxt")
    keep("loadtxt_edgelist", sec, len(s20), "read_edgelist_loadtxt")

    # the Hornet / Gunrock analogue, at scale 18
    el, t_el = wall_s(lambda: baselines.read_edgelist_naive(p18, **cpu))
    check_el(el, s18, d18, v18, "naive")
    c, t_build = wall_s(lambda: baselines.csr_pigo(el, **cpu))
    check_csr(c, oracle18, False, "naive + csr_pigo")
    keep("naive_edgelist_scale18", t_el, len(s18),
         "read_edgelist_naive, scale 18")
    keep("naive_csr_scale18", t_el + t_build, len(s18),
         "read_edgelist_naive + csr_pigo, scale 18")
    del el, c

    # one edge list, both builds: the host engine's edges built on the card
    w = counts[-1]
    el, t_el = wall_s(lambda: repro_torch.load_edgelist(
        p20, engine="threads", num_workers=w))
    require(el.src.is_cuda and el.dst.is_cuda,
            "3m: the threads engine's edge list is on the card")
    csr, t_build, lc = counted(torch, kernels, lambda: convert_to_csr(el))
    need(lc, ("degree_histogram", "exclusive_scan"),
         "3m card build of the threads edge list")
    require(torch.equal(csr.offsets.cpu(), host.offsets)
            and torch.equal(csr.targets.cpu(), host.targets),
            "3m: the card build equals the host build")
    check_csr(csr, oracle20, False, "3m card build of the threads edge list")
    launches["host engines: card build of a threads edge list"] = lc
    both = {"workers": w, "edgelist_to_card_s": t_el, "card_build_s": t_build,
            "launches": lc}
    del el, csr, host

    card_eps = loaders["gvel_card_csr"]["edges_per_s"]
    speedup = {k: card_eps / r["edges_per_s"] for k, r in loaders.items()
               if k != "gvel_card_csr"}
    doubling = {}
    for kind in ("edgelist", "csr"):
        doubling[f"threads_{kind}"] = {
            f"{a}->{b}": loaders[f"threads_w{a}_{kind}"]["seconds"]
            / loaders[f"threads_w{b}_{kind}"]["seconds"]
            for a, b in zip(counts, counts[1:])}
    doubling["csr_staged_np"] = {
        f"{a}->{b}": loaders[f"csr_staged_np_w{a}"]["seconds"]
        / loaders[f"csr_staged_np_w{b}"]["seconds"]
        for a, b in zip(counts, counts[1:])}
    row = {"file": {"scale": HOST_SCALE, "edges": len(s20),
                    "bytes": os.path.getsize(p20)},
           "naive_file": {"scale": NAIVE_SCALE, "edges": len(s18),
                          "bytes": os.path.getsize(p18)},
           "workers": counts,
           "loaders": loaders, "card_speedup": speedup,
           "thread_doubling": doubling, "both_builds": both,
           "host": machine, "card": smi_line()}
    report["host_engines"] = row
    say(json.dumps({"host_engines": {k: {"seconds": r["seconds"],
                                         "edges_per_s": r["edges_per_s"]}
                                     for k, r in loaders.items()}}))
    say(json.dumps({"card_speedup_by_edges_per_s": speedup}))
    say(json.dumps({"thread_doubling": doubling, "workers": counts}))
    say(json.dumps({"both_builds": both}))
    say(json.dumps({"host": machine, "card": row["card"]}))
    row["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 3m: the host engines and the paper's baselines agree with "
        f"the oracle bitwise ({row['phase_s']:.1f}s)")
    return launches


# ---------------------------------------------------------------------------
# phase 3n: recurrent prefill at full width through the chunked scan
# ---------------------------------------------------------------------------

PREFILL_ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")
PREFILL_ROWS, PREFILL_LEN = 2, 4096      # 16 of the layers' 256-token chunks
PREFILL_CHUNK = 256
# the kernel's prefill against the same model with the plain scan forced,
# on the same card, weights and tokens.  Layer by layer, each recurrent
# mix run again with the plain scan on the kernel path's own input: the
# scans differ by f32 rounding only, within SCAN_TOL a chunk, so the final
# state after 16 chunks within 16 x SCAN_TOL of max(1, its largest); the
# mix's bf16 output within the repo's TOL (2e-2) of its largest (an ulp
# of bf16 flips where the two f32 results straddle a rounding boundary).
# Whole model: each layer rounds to bf16, so flips carry and grow through
# the layers; the logits are held at LOGIT_TOL (two bf16 paths of one
# model, as phase 3f holds them) and each layer's final state is recorded
# (on falcon-mamba-7b up to 0.044 of its largest in the deep layers, on an
# H100: PERF.md, section 6)
LAYER_STATE_TOL = 16 * 1e-5
LAYER_OUT_TOL = 2e-2


@contextlib.contextmanager
def plain_scan():
    """The layers' scan swapped for its plain version while the block
    runs (this phase's comparison only; the port has no such switch)."""
    from repro_torch.kernels import linear_scan_ref
    from repro_torch.models import mamba, rglru

    def plain(a, b, h0, *, reverse=False):
        return linear_scan_ref(a, b, h0, reverse)
    saved = mamba.linear_scan, rglru.linear_scan
    mamba.linear_scan = rglru.linear_scan = plain
    try:
        yield
    finally:
        mamba.linear_scan, rglru.linear_scan = saved


@contextlib.contextmanager
def layer_by_layer(errs):
    """Each recurrent mix run twice while the block runs: as it is (the
    kernel), then with the plain scan on the same input; appends
    ``(state err, output err)`` of each call to ``errs`` and returns the
    kernel's results."""
    from repro_torch.models import mamba, rglru
    saved = mamba.mamba_mix, rglru.rglru_mix

    def twice(mix):
        def run(p, u_raw, gate, cfg, **kw):
            out, state = mix(p, u_raw, gate, cfg, **kw)
            with plain_scan():
                pout, pstate = mix(p, u_raw, gate, cfg, **kw)
            errs.append((scan_err(state, pstate),
                         float((out.float() - pout.float()).abs().max()
                               / pout.float().abs().max())))
            return out, state
        return run
    mamba.mamba_mix, rglru.rglru_mix = twice(saved[0]), twice(saved[1])
    try:
        yield
    finally:
        mamba.mamba_mix, rglru.rglru_mix = saved


def prefill_ms(torch, fn) -> float:
    """One prefill's ms on CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def recurrent_prefill(torch, kernels, arch, snap_path, report):
    """One arch of phase 3n at its published widths and depth."""
    from repro_torch.configs import get_config
    from repro_torch.data import prng
    from repro_torch.data.walks import random_walks
    from repro_torch.models import forward_prefill, init_params
    from repro_torch.models.blocks import layer_kinds
    import repro_torch
    t_arch = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    free_card(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row = {"arch": arch, "layers": cfg.num_layers, "rows": PREFILL_ROWS,
           "tokens_a_row": PREFILL_LEN,
           "chunks_a_layer": PREFILL_LEN // PREFILL_CHUNK,
           "widths": {k: getattr(cfg, k) for k in (
               "d_model", "d_inner", "lru_width", "vocab_size")}}
    if cfg.ssm:
        row["widths"]["d_state"] = cfg.ssm.d_state
    recurrent = sum(k in ("mamba", "rglru") for k in layer_kinds(cfg))
    row["recurrent_layers"] = recurrent

    # prompts: the port's walks over 3c's raw snapshot, mod the vocab
    csr = repro_torch.open_graph(snap_path).csr()
    walks = random_walks(csr.offsets, csr.targets, prng.key(SEED, device=dev),
                         num_walks=PREFILL_ROWS, length=PREFILL_LEN,
                         num_vertices=csr.num_vertices)
    require(walk_steps_valid(torch, walks, csr.offsets, csr.targets),
            f"{arch}: every prompt step is an edge or a dead-end self-loop")
    toks = {"tokens": (walks % cfg.vocab_size).to(torch.int32)}
    del csr, walks
    t0 = time.perf_counter()
    model = init_params(cfg, SEED)
    torch.cuda.synchronize()
    row["init_s"] = time.perf_counter() - t0
    row["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())

    def prefill():
        return forward_prefill(model, toks, cfg, PREFILL_LEN)

    with torch.inference_mode():
        # the main path: the counts set to 0 just before, read just after
        kernels.reset_launches()
        t0 = time.perf_counter()
        logits, caches = prefill()
        torch.cuda.synchronize()
        row["first_prefill_s"] = time.perf_counter() - t0
        row["launches"] = dict(kernels.LAUNCHES)
        want = recurrent * PREFILL_LEN // PREFILL_CHUNK
        need(row["launches"], ("linear_scan",), f"{arch} prefill")
        require(row["launches"]["linear_scan"] == want,
                f"{arch}: {row['launches']['linear_scan']} linear_scan "
                f"launches, not {want} (layers x chunks)")
        key = "ssm" if cfg.ssm else "h"
        states = [c[key] for c in caches if key in c]
        with plain_scan():
            kernels.reset_launches()
            plogits, pcaches = prefill()
            torch.cuda.synchronize()
            require(kernels.LAUNCHES["linear_scan"] == 0,
                    f"{arch}: the plain scan launches no kernel")
        pstates = [c[key] for c in pcaches if key in c]
        require(bool(torch.isfinite(logits.float()).all())
                and tuple(logits.shape) == (PREFILL_ROWS, cfg.vocab_size),
                f"{arch}: finite logits of shape (rows, vocab)")
        lerr = float((logits.float() - plogits.float()).abs().max())
        serrs = [float((s - p).abs().max() / p.abs().max())
                 for s, p in zip(states, pstates)]
        row["against_plain_scan"] = {
            "logits_max_abs_err": lerr, "logits_tol": LOGIT_TOL,
            "greedy_equal": bool(torch.equal(logits.argmax(-1),
                                             plogits.argmax(-1))),
            "state_rel_err_by_layer": serrs}
        require(lerr <= LOGIT_TOL, f"{arch}: logits {lerr} from the plain "
                f"scan's (tol {LOGIT_TOL})")
        del logits, caches, plogits, pcaches, states, pstates
        errs = []
        with layer_by_layer(errs):
            prefill()
        require(len(errs) == recurrent, f"{arch}: every recurrent layer "
                f"checked ({len(errs)})")
        row["layer_by_layer"] = {
            "state_err": [e[0] for e in errs], "state_tol": LAYER_STATE_TOL,
            "out_rel_err": [e[1] for e in errs], "out_tol": LAYER_OUT_TOL}
        for i, (serr, oerr) in enumerate(errs):
            require(serr <= LAYER_STATE_TOL and oerr <= LAYER_OUT_TOL,
                    f"{arch} recurrent layer {i} against its plain scan: "
                    f"state {serr} (tol {LAYER_STATE_TOL}), output {oerr} "
                    f"(tol {LAYER_OUT_TOL})")

        # in turns: kernel, plain, plain, kernel
        times = {"kernel": [], "plain": []}
        for who in ("kernel", "plain", "plain", "kernel"):
            if who == "plain":
                with plain_scan():
                    times[who].append(prefill_ms(torch, prefill))
            else:
                times[who].append(prefill_ms(torch, prefill))
        ms = sum(times["kernel"]) / 2
        row["prefill_ms"] = times["kernel"]
        row["plain_scan_prefill_ms"] = times["plain"]
        row["tokens_per_s"] = PREFILL_ROWS * PREFILL_LEN / ms * 1e3

        with traced(torch) as prof:
            prefill()
        launches, records = card_records(prof)
        kept = [records[e.id] for e in launches if e.id in records]
        scan = [r for r in kept if "linear_scan" in r.name]
        row["profile"] = {
            "launches": len(launches),
            "kernel_launches": sum("LaunchKernel" in e.name
                                   for e in launches),
            "device_ms": sum(r.time_range.end - r.time_range.start
                             for r in kept) / 1e3,
            "records_lost": len(launches) - len(kept),
            "linear_scan_calls": len(scan),
            "linear_scan_device_ms": sum(r.time_range.end
                                         - r.time_range.start
                                         for r in scan) / 1e3}
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del model, toks
    free_card(torch)
    row["arch_s"] = time.perf_counter() - t_arch
    report.append(row)
    say(json.dumps({"recurrent_prefill": row}))
    return row["launches"]


def phase_recurrent_prefill(torch, kernels, snap_path, report):
    """Recurrent prefill at full width (phase 3n): falcon-mamba-7b (64
    layers) and recurrentgemma-2b (26), bf16 weights drawn on the card,
    one after the other.  Returns each arch's launch counts."""
    t_phase = time.perf_counter()
    rows, by_path = [], {}
    for arch in PREFILL_ARCHS:
        by_path[f"recurrent_prefill: {arch}"] = recurrent_prefill(
            torch, kernels, arch, snap_path, rows)
    report["recurrent_prefill"] = {"archs": rows,
                                   "phase_s": time.perf_counter() - t_phase}
    say(f"phase 3n: falcon-mamba-7b and recurrentgemma-2b prefill "
        f"{PREFILL_ROWS} x {PREFILL_LEN} tokens at full width through "
        f"linear_scan ({report['recurrent_prefill']['phase_s']:.1f}s)")
    return by_path


def phase_kernels(torch, repro_torch, kernels, path22, v22, runs, consumers,
                  report):
    """Each kernel at the main path's shapes: parity, then times.  ``runs``
    maps a method to the launch counts of its scale-22 main-path run; a row
    reports those of the default method, ``staged``.  Returns the inputs
    the parent comparison reuses."""
    from repro_torch.core import blocks, codecs, parse
    dev = torch.device("cuda", 0)
    launches = runs["staged"]
    rows = []

    # parse_bytes: one full batch (8 blocks of 256 KiB + 64) of the file
    source, _ = codecs.open_block_source(path22)
    plan = blocks.plan_blocks(source.length, beta=256 * 1024, overlap=64)
    mid = plan.num_blocks // 2
    flat = source.stage(plan, np.arange(mid, mid + 8))
    span = torch.from_numpy(flat.copy()).to(dev)
    bufs = span.as_strided((8, plan.buf_len), (plan.beta, 1))
    os_, oe = blocks.owned_range(plan)
    got = kernels.parse_bytes(bufs, os_, oe, weighted=False, base=1)
    want = kernels.parse_bytes_ref(bufs, os_, oe, weighted=False, base=1)
    check_bytes(got, want, False, "parse_bytes (main shape)")
    n_valid = int(want[0].sum())
    rows.append(dict(
        name="parse_bytes", route="cuda",
        source="src/repro_torch/csrc/parse_edges.cu",
        replaces="src/repro/kernels/parse_edges/kernel.py:125",
        launches=launches["parse_bytes"], max_abs_err=0,
        **timed(torch, lambda: kernels.parse_bytes(bufs, os_, oe,
                                                   weighted=False, base=1)),
        plain_ms=cuda_ms(torch, lambda: kernels.parse_bytes_ref(
            bufs, os_, oe, weighted=False, base=1), 5, warmup=1),
        bound_ms=bound_ms(flat.size + 8 * plan.buf_len + 8 * n_valid),
        bound_by="bytes", library_ms=None, bitwise=True,
        shape=f"(8, {plan.buf_len}) uint8 rows {plan.beta} apart; "
              f"{n_valid} lines; launches = its launches in the staged "
              f"scale-22 load (parse_blocks only)"))

    # parse_accumulate: the same batch packed at a running total, as the
    # loader's step; bitwise against the plain path on the card
    bound = 8 * plan.edge_cap
    start = 1000
    acc = parse.make_accumulators(start + bound, weighted=False, device=dev)
    total = torch.tensor(start, dtype=torch.int32, device=dev)

    def fused():
        return kernels.parse_accumulate(acc[0], acc[1], None, total, bufs,
                                        os_, oe, weighted=False, base=1,
                                        edge_bound=bound)

    def plain_accumulate():
        return kernels.parse_accumulate_ref(acc[0].clone(), acc[1].clone(),
                                            None, total, bufs, os_, oe,
                                            weighted=False, base=1,
                                            edge_bound=bound)
    want = plain_accumulate()
    got = fused()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and int(got[3]) == int(want[3]) == start + n_valid,
            "parse_accumulate (main shape) vs its plain path")
    rows.append(dict(
        name="parse_accumulate", route="cuda",
        source="src/repro_torch/csrc/parse_edges.cu",
        replaces="src/repro/kernels/parse_edges/kernel.py:125 (+ "
                 "src/repro/core/parse.py:232 _compact_accumulate)",
        launches=launches["parse_accumulate"], max_abs_err=0,
        **timed(torch, fused),
        plain_ms=cuda_ms(torch, plain_accumulate, 5, warmup=1),
        bound_ms=bound_ms(flat.size + 8 * bound + 8), bound_by="bytes",
        library_ms=None, bitwise=True,
        shape=f"(8, {plan.buf_len}) uint8 rows {plan.beta} apart -> "
              f"{n_valid} edges in a window of {bound} int32 x 2"))

    # parse_blocks: the parse kernel plus the per-block torch compaction
    # (XLA outside the Pallas kernel in the reference), at the same batch
    cap = plan.buf_len // 4 + 2
    got = parse.parse_blocks(bufs, os_, oe, weighted=False, base=1,
                             edge_cap=cap)
    want = parse.parse_blocks(bufs.cpu(), os_, oe, weighted=False, base=1,
                              edge_cap=cap)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)
                if b is not None) and got[2] is None,
            "parse_blocks (main shape) vs its CPU run")

    def plain_blocks():
        valid, s_b, d_b, _w = kernels.parse_bytes_ref(bufs, os_, oe,
                                                      weighted=False, base=1)
        return parse._compact_blocks(valid, s_b, d_b, None, edge_cap=cap)
    require(all(torch.equal(a, b) for a, b in zip(got, plain_blocks())
                if b is not None), "parse_blocks vs its plain version")
    rows.append(dict(
        name="parse_blocks", route="cuda",
        source="src/repro_torch/csrc/parse_edges.cu + "
               "src/repro_torch/core/parse.py",
        replaces="src/repro/kernels/parse_edges/kernel.py:184",
        launches=launches["parse_blocks"], max_abs_err=0,
        **timed(torch, lambda: parse.parse_blocks(
            bufs, os_, oe, weighted=False, base=1, edge_cap=cap)),
        plain_ms=cuda_ms(torch, plain_blocks, 5, warmup=1),
        bound_ms=bound_ms(flat.size + 8 * cap * 8 + 8 * 4), bound_by="bytes",
        library_ms=None, bitwise=True,
        shape=f"(8, {plan.buf_len}) uint8 -> (8, {cap}) int32 x 2 + (8,); "
              f"launches = its calls in the staged scale-22 load"))
    del acc

    # the build's inputs: the stream's accumulators as the loader hands
    # them over, and a copy of their n edges
    from repro_torch.core import build
    (src, dst, _w, total), _cap = repro_torch.open_graph(path22).stream()
    n = int(total)
    src_n, dst_n = src[:n].clone(), dst[:n].clone()
    # the staged build as the loader runs it, in the accumulators: its peak
    # above them, its launches, bitwise the main path's CSR
    csr = consumers["csr"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    offsets, targets, _ = build.csr_staged(src, dst, None, v22, rho=RHO,
                                           num_edges=n, donate=True)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated(dev) - base
    build_launches = {k: c for k, c in kernels.LAUNCHES.items() if c}
    require(torch.equal(offsets.long(), csr.offsets)
            and torch.equal(targets, csr.targets),
            "csr_staged in the accumulators: bitwise the main path's CSR")
    require(build_launches == {"degree_histogram": 1, "exclusive_scan": 1,
                               "staged_merge": 1},
            f"csr_staged: one histogram, scan and merge ({build_launches})")
    # the design's peak: 12 B an edge and (8 rho + 12) B a vertex
    build_peak_bound = 12 * n + (8 * RHO + 12) * v22
    require(build_peak <= build_peak_bound,
            f"csr_staged: {build_peak} B above the accumulators, over "
            f"{build_peak_bound}")
    del src, dst, offsets, targets
    # the merge's inputs: the build's sorted (partition, source) keys and
    # values and its table
    offsets, skeys, svals, delta = build.staged_pairs(src_n, dst_n, None,
                                                      v22, rho=RHO)
    # the histogram's two inputs on the path, each with its launches and
    # times per load: `staged` (the default) counts the sorted (partition,
    # source) keys over rho*V bins in one launch; `global` and `binned`
    # count the ids in stream order over V bins in one launch.  The library
    # call is one torch.bincount.
    key = torch.where(src_n >= 0, src_n, v22)
    inputs = {"staged": (skeys, RHO * v22), "global": (key, v22)}
    iters = {"ms": 20, "plain_ms": 5, "library_ms": 5}
    hist = {}
    for method, (x, bins) in inputs.items():
        fns = {"ms": lambda x=x, b=bins: kernels.degree_histogram(
                   x, num_vertices=b),
               "plain_ms": lambda x=x, b=bins: kernels.degree_histogram_ref(
                   x, num_vertices=b),
               "library_ms": lambda x=x, b=bins: torch.bincount(
                   x, minlength=b + 1)[:b]}
        got, want, library = (f() for f in fns.values())
        require(torch.equal(got, want),
                f"degree_histogram (main shape, {method})")
        require(torch.equal(library.int(), got),
                f"degree_histogram vs torch.bincount ({method})")
        del got, want, library
        hist[method] = {k: cuda_ms(torch, f, iters[k])
                        for k, f in fns.items()}
        for k in ("ms", "library_ms"):
            hist[method][k.replace("ms", "device_ms")] = device_ms(
                torch, fns[k], 5)
        hist[method].update(
            launches=runs[method]["degree_histogram"],
            bound_ms=bound_ms(4 * x.numel() + 4 * bins),
            shape=f"({x.numel()},) int32 "
                  + ("sorted (partition, source) keys" if method == "staged"
                     else "stream order") + f" -> ({bins},)")
    staged = hist["staged"]
    rows.append(dict(
        name="degree_histogram", route="cuda",
        source="src/repro_torch/csrc/degree_histogram.cu",
        replaces="src/repro/kernels/degree_histogram/kernel.py:48",
        max_abs_err=0, bound_by="bytes", bitwise=True, **staged,
        global_and_binned=hist["global"]))

    deg = kernels.degree_histogram(key, num_vertices=v22)
    require(torch.equal(kernels.csr_offsets(deg), offsets),
            "the staged build's offsets: the stream-order degrees' scan")
    got = kernels.exclusive_scan(deg)
    want = kernels.exclusive_scan_ref(deg)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "exclusive_scan (main shape)")
    require(got[1].data_ptr() == got[0].data_ptr() + 4 * v22,
            "exclusive_scan (main shape): prefix and total in one buffer")
    offsets = kernels.csr_offsets(deg)
    require(offsets.shape == (v22 + 1,) and torch.equal(offsets[:-1], want[0])
            and int(offsets[-1]) == int(want[1]),
            "csr_offsets (main shape)")

    def library():
        return torch.cumsum(deg, 0, dtype=torch.int32)
    rows.append(dict(
        name="exclusive_scan", route="cuda",
        source="src/repro_torch/csrc/exclusive_scan.cu",
        replaces="src/repro/kernels/exclusive_scan/kernel.py:38",
        launches=launches["exclusive_scan"], max_abs_err=0,
        **timed(torch, lambda: kernels.exclusive_scan(deg)),
        plain_ms=cuda_ms(torch, lambda: kernels.exclusive_scan_ref(deg), 10),
        bound_ms=bound_ms(8 * v22 + 4), bound_by="bytes",
        library_ms=cuda_ms(torch, library, 50),
        library_device_ms=device_ms(torch, library), bitwise=True,
        shape=f"N={v22} int32 -> N+1"))

    # staged_merge on the build's sorted pairs and table, bitwise its plain
    # version and the main path's targets; beside it the device ms of the
    # whole staged build by kernel, its pair sort (CUB's) among them
    got, _ = kernels.staged_merge(skeys, svals, delta)
    want, _ = kernels.staged_merge_ref(skeys, svals, delta)
    require(torch.equal(got, want) and torch.equal(got, csr.targets),
            "staged_merge (main shape): its plain version, the main path")
    del got, want
    by_kernel = device_ms_by_name(torch, lambda: build.csr_staged(
        src_n, dst_n, None, v22, rho=RHO))
    rows.append(dict(
        name="staged_merge", route="cuda",
        source="src/repro_torch/csrc/staged_merge.cu",
        replaces="none: XLA ops of src/repro/core/build.py:102 csr_staged "
                 "(rank searchsorted and gathers, base gather, select, "
                 "scatter)",
        launches=launches["staged_merge"], max_abs_err=0,
        **timed(torch, lambda: kernels.staged_merge(skeys, svals, delta)),
        plain_ms=cuda_ms(torch, lambda: kernels.staged_merge_ref(
            skeys, svals, delta), 5, warmup=1),
        # the keys and values read, the targets written, the table once
        bound_ms=bound_ms(12 * n + 4 * delta.numel()), bound_by="bytes",
        library_ms=None, bitwise=True,
        build_device_ms=sum(by_kernel.values()),
        build_by_kernel=by_kernel,
        sort_device_ms=sum(ms for k, ms in by_kernel.items()
                           if "RadixSort" in k),
        build_launches=build_launches,
        build_peak_above_accumulators_bytes=build_peak,
        build_peak_bound_bytes=build_peak_bound,
        shape=f"({n},) sorted int32 (partition, source) keys and targets, "
              f"a ({RHO * v22},) int32 table -> ({n},) int32"))

    # neighbor_gather on the consumer path's two inputs
    gather = {}
    for name, ids in consumers["inputs"].items():
        nbrs, gdeg = kernels.neighbor_gather(ids, csr.offsets, csr.targets,
                                             width=GATHER_WIDTH)
        want = kernels.neighbor_gather_ref(ids, csr.offsets, csr.targets,
                                           width=GATHER_WIDTH)
        require(torch.equal(nbrs, want[0]) and torch.equal(gdeg, want[1]),
                f"neighbor_gather (main shape, {name})")
        del nbrs, want
        # the bytes that must come from memory: the output and the degrees
        # per id, the offsets and row reads once per distinct id (a repeated
        # id's row is already on chip)
        b = ids.numel()
        uniq, first = np.unique(ids.cpu().numpy(), return_index=True)
        read = int(gdeg[torch.from_numpy(first).to(dev)].clamp(
            0, GATHER_WIDTH).sum())
        n_off = np.unique(np.concatenate([uniq, uniq + 1])).size
        gather[name] = dict(
            **timed(torch, lambda ids=ids: kernels.neighbor_gather(
                ids, csr.offsets, csr.targets, width=GATHER_WIDTH), 20),
            plain_ms=cuda_ms(torch, lambda ids=ids:
                             kernels.neighbor_gather_ref(
                                 ids, csr.offsets, csr.targets,
                                 width=GATHER_WIDTH), 3, warmup=1),
            bound_ms=bound_ms(4 * b + 8 * n_off + 4 * read
                              + 4 * b * GATHER_WIDTH + 4 * b),
            # a yardstick, not a bound: writing the output alone
            output_fill=timed(torch, lambda b=b: torch.full(
                (b, GATHER_WIDTH), -1, dtype=torch.int32, device=dev), 20),
            distinct_ids=int(uniq.size), targets_read=read,
            shape=f"B={b} int32 ids ({name}), offsets (V+1={v22 + 1},) "
                  f"int64, targets (E={csr.targets.numel()},) int32, "
                  f"width {GATHER_WIDTH}")
    rows.append(dict(
        name="neighbor_gather", route="cuda",
        source="src/repro_torch/csrc/neighbor_gather.cu",
        replaces="src/repro/kernels/neighbor_gather/kernel.py:49",
        launches=consumers["launches"]["neighbor_gather"], max_abs_err=0,
        bound_by="bytes", library_ms=None, bitwise=True,
        **gather["uniform"], edge_sources=gather["edge_sources"]))
    report["kernels"] = rows
    return {"bufs": bufs, "owned": (os_, oe), "edge_bound": bound,
            "deg": deg, "hist": inputs, "v": v22, "csr": csr,
            "gather": consumers["inputs"], "build": (src_n, dst_n)}


# linear_scan at the chunk shapes of the recurrent layers at full width:
# falcon-mamba-7b's (2 rows, 256 tokens, d_inner 8,192 x d_state 16) and
# recurrentgemma-2b's (8 rows, 256 tokens, lru_width 2,560)
SCAN_SHAPES = {"mamba_chunk": (2, 256, 8192 * 16),
               "rglru_chunk": (8, 256, 2560)}
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores


def phase_scan_kernel(torch, kernels, report):
    """Phase 4 for ``linear_scan``: at each chunk shape against the plain
    version (within SCAN_TOL) and the sequential loop on the card
    (bitwise), then timed beside the plain version and its bound.  No
    single PyTorch call computes a first-order recurrence: no library
    time.  The row's ``launches`` are phase 3n's."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    for name, shape in SCAN_SHAPES.items():
        a, x, h0 = scan_inputs(torch, g, shape, False, dev)
        got = kernels.linear_scan(a, x, h0)
        err = scan_err(got, kernels.linear_scan_ref(a, x, h0))
        require(err <= SCAN_TOL, f"linear_scan ({name}): {err} against the "
                f"plain version")
        require(torch.equal(got, kernels.linear_scan_loop(a, x, h0)),
                f"linear_scan ({name}): bitwise the sequential loop")
        del got
        b, t, c = shape
        nbytes = 12 * b * t * c + 4 * b * c
        flops = 2 * b * t * c
        rows[name] = dict(
            max_abs_err=err,
            **timed(torch, lambda: kernels.linear_scan(a, x, h0), 20),
            plain_ms=cuda_ms(torch, lambda: kernels.linear_scan_ref(
                a, x, h0), 5, warmup=1),
            plain_device_ms=device_ms(
                torch, lambda: kernels.linear_scan_ref(a, x, h0), 5),
            bound_ms=max(bound_ms(nbytes), flops / F32_FLOPS_PER_S * 1e3),
            bytes=nbytes, flops=flops,
            shape=f"{shape} f32 a, b -> h, h0 ({b}, {c})")
        del a, x, h0
    torch.cuda.empty_cache()
    main = rows["mamba_chunk"]
    row = dict(
        name="linear_scan", route="cuda",
        source="src/repro_torch/csrc/linear_scan.cu",
        replaces="none: XLA's jax.lax.associative_scan at "
                 "src/repro/models/mamba.py:61 and "
                 "src/repro/models/rglru.py:75 (no Pallas kernel)",
        launches=0, bound_by="bytes", library_ms=None, bitwise=False,
        **main, rglru_chunk=rows["rglru_chunk"])
    report["kernels"].append(row)
    say(json.dumps({"linear_scan": row}))
    return row


def phase_parent(torch, kernels, parent_dir, inputs, report):
    """This tree's kernels against those of the checkout at ``parent_dir``,
    on the same inputs, timed in turns (parent, this, this, parent); both
    must agree bitwise.  The histogram on both of its inputs (`staged`'s
    sorted keys over rho*V bins, the stream-order ids over V); the whole
    `staged` build on the scale-22 edges, with each side's device ms by
    kernel; the gather on both of its inputs."""
    import importlib.util
    pkg = os.path.join(os.path.abspath(parent_dir), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        "repro_torch_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    parent = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_parent"] = parent
    spec.loader.exec_module(parent)
    from repro_torch_parent import kernels as pkernels
    from repro_torch_parent.core import parse as pparse
    from repro_torch.core import parse
    dev = torch.device("cuda", 0)
    bufs, (os_, oe), bound = (inputs["bufs"], inputs["owned"],
                              inputs["edge_bound"])
    deg, v, csr = inputs["deg"], inputs["v"], inputs["csr"]
    hist = inputs["hist"]
    accs = {name: parse.make_accumulators(bound, weighted=False, device=dev)
            for name in ("parent", "this")}
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    fns = {
        "exclusive_scan": {"parent": lambda: pkernels.exclusive_scan(deg),
                           "this": lambda: kernels.exclusive_scan(deg)},
        "parse_bytes": {
            "parent": lambda: pkernels.parse_bytes(bufs, os_, oe,
                                                   weighted=False, base=1),
            "this": lambda: kernels.parse_bytes(bufs, os_, oe,
                                                weighted=False, base=1)},
        "parse_accumulate": {
            who: (lambda mod, a: lambda: mod.parse_accumulate(
                a[0], a[1], None, zero, bufs, os_, oe, weighted=False,
                base=1, edge_bound=bound))(mod, accs[who])
            for who, mod in (("parent", pparse), ("this", parse))},
    }
    for method, name in (("staged", "degree_histogram_staged"),
                         ("global", "degree_histogram_stream")):
        fns[name] = {
            who: (lambda mod, x, b: lambda: mod.degree_histogram(
                x, num_vertices=b))(mod, *hist[method])
            for who, mod in (("parent", pkernels), ("this", kernels))}
    # the whole staged build (the parent's sorts and scatters in PyTorch,
    # this tree's pair sort and merge)
    from repro_torch.core import build
    from repro_torch_parent.core import build as pbuild
    s2, d2 = inputs["build"]
    fns["csr_staged"] = {
        "parent": lambda: pbuild.csr_staged(s2, d2, None, v),
        "this": lambda: build.csr_staged(s2, d2, None, v)}
    for name, ids in inputs["gather"].items():
        fns[f"neighbor_gather_{name}"] = {
            who: (lambda mod, ids: lambda: mod.neighbor_gather(
                ids, csr.offsets, csr.targets, width=GATHER_WIDTH))(mod, ids)
            for who, mod in (("parent", pkernels), ("this", kernels))}

    def parts(r):
        return list(r) if isinstance(r, (list, tuple)) or r.dim() > 1 \
            else [r]
    out = {}
    for name, pair in fns.items():
        a, b = pair["parent"](), pair["this"]()
        torch.cuda.synchronize()
        if name == "parse_bytes":
            check_bytes([t.cpu() if t is not None else None for t in b],
                        [t.cpu() if t is not None else None for t in a],
                        False, "parent vs this: parse_bytes")
        else:
            a, b = parts(a), parts(b)
            require(len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b) if x is not None),
                f"parent vs this: {name}")
        del a, b
        turns = []
        for who in ("parent", "this", "this", "parent"):
            turns.append(dict(who=who, **timed(torch, pair[who])))
        out[name] = {who: {k: sum(t[k] for t in turns if t["who"] == who) / 2
                           for k in ("ms", "device_ms")}
                     for who in ("parent", "this")}
        out[name]["turns"] = turns
    out["csr_staged"]["by_kernel"] = {
        who: device_ms_by_name(torch, fn)
        for who, fn in fns["csr_staged"].items()}
    report["parent"] = out
    say(json.dumps({"parent": out}))


def phase_breakdown(torch, repro_torch, path22, report):
    """Where a scale-22 staged load spends its time."""
    from repro_torch.core import blocks, build, codecs, parse
    dev = torch.device("cuda", 0)
    beta, overlap, bb = 256 * 1024, 64, 8
    source, _ = codecs.open_block_source(path22)
    plan = blocks.plan_blocks(source.length, beta=beta, overlap=overlap)
    arena = blocks.StagingArena(blocks.flat_len(bb, plan), pin=True)
    t0 = time.perf_counter()
    for i, lo in enumerate(range(0, plan.num_blocks, bb)):
        source.stage(plan, np.arange(lo, min(lo + bb, plan.num_blocks)),
                     arena=arena.slot(i), check_lines=True)
    stage_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (src, dst, _w, total), cap = repro_torch.open_graph(path22).stream()
    n = int(total)
    stream_s = time.perf_counter() - t0

    # parse alone, on bytes already on the card
    data = torch.from_numpy(np.fromfile(path22, dtype=np.uint8))
    padded = torch.full((overlap + plan.num_blocks * beta + overlap,), 10,
                        dtype=torch.uint8, device=dev)
    padded[overlap:overlap + len(data)] = data.to(dev)
    del data
    os_, oe = blocks.owned_range(plan)
    acc = parse.make_accumulators(cap, weighted=False, device=dev)

    def parse_all():
        a = (acc[0], acc[1], None, torch.zeros((), dtype=torch.int32,
                                                device=dev))
        for lo in range(0, plan.num_blocks, bb):
            nb = min(bb, plan.num_blocks - lo)
            bufs = padded[lo * beta:].as_strided((nb, plan.buf_len),
                                                 (beta, 1))
            a = parse.parse_accumulate(*a, bufs, os_, oe, weighted=False,
                                       base=1,
                                       edge_bound=nb * plan.edge_cap)
        return a
    parse_ms = cuda_ms(torch, parse_all, 1, warmup=1)
    require(int(parse_all()[3]) == n, "breakdown: parse alone edge count")
    del padded

    v = int(torch.maximum(src.max(), dst.max())) + 1
    s2, d2 = src[:n], dst[:n]
    builds = {m: cuda_ms(torch, lambda m=m: getattr(build, f"csr_{m}")(
        s2, d2, None, v), 2, warmup=1) for m in ("staged", "global", "binned")}
    h2d_host = torch.empty(blocks.flat_len(bb, plan), dtype=torch.uint8,
                           pin_memory=True)
    h2d_dev = torch.empty_like(h2d_host, device=dev)
    nbatches = -(-plan.num_blocks // bb)
    h2d_ms = cuda_ms(torch, lambda: h2d_dev.copy_(h2d_host,
                                                  non_blocking=True),
                     nbatches, warmup=2) * nbatches
    row = {"file_bytes": plan.file_len, "batches": nbatches,
           "stage_host_s": stage_s, "h2d_all_batches_ms": h2d_ms,
           "parse_device_resident_ms": parse_ms, "stream_s": stream_s,
           "build_ms": builds}
    report["breakdown"] = row
    say(json.dumps({"breakdown": row}))


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def phase_profile(torch, repro_torch, path22, report):
    """One traced scale-22 staged load: the device's busy share (the union
    of the card's kernel, copy and memset intervals over the load's wall
    time) and the top device ops.  Only device-side events count, so an
    aten op and the kernel it launches are not counted twice, and a copy
    that overlaps a kernel counts once."""
    from torch.autograd import DeviceType
    with traced(torch) as prof:
        t0 = time.perf_counter()
        repro_torch.open_graph(path22).csr()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    on_card = list(card_records(prof)[1].values())
    require(len(on_card) > 0, "profile: no device events in the trace")
    spans = [(e.time_range.start, e.time_range.end) for e in on_card]
    busy = union_us(spans) / 1e6
    summed = sum(end - start for start, end in spans) / 1e6

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=device_us, reverse=True)
    calls = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            calls[e.key] = calls.get(e.key, 0) + e.count
    watched = ("parse_accumulate_kernel", "parse_bytes_kernel",
               "index_elementwise_kernel", "exclusive_scan_kernel",
               "degree_histogram_kernel", "staged_merge_kernel", "Memset")
    row = {"wall_s": wall, "device_events": len(on_card),
           "calls_of": {w: sum(c for k, c in calls.items() if w in k)
                        for w in watched},
           "device_busy_s": busy, "device_busy_share": busy / wall,
           "device_idle_share": 1 - busy / wall,
           "device_time_summed_s": summed,
           "top": [{"name": e.key[:60], "calls": e.count,
                    "device_ms": device_us(e) / 1e3} for e in top[:8]]}
    report["profile"] = row
    say(json.dumps({"profile": row}))


def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of another commit whose kernels to "
                         "time in turns with these")
    ap.add_argument("--cards", type=int, metavar="N",
                    help="only the sharded load, over NCCL: worlds of 1 "
                         "and N ranks, one card each, then data-parallel "
                         "training across the N cards, then tensor-parallel "
                         "decode and training, then FSDP training (needs N "
                         "cards)")
    ap.add_argument("--shard-rank", metavar="CFG", help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", metavar="CFG", help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", metavar="CFG", help=argparse.SUPPRESS)
    ap.add_argument("--fsdp-rank", metavar="CFG", help=argparse.SUPPRESS)
    ap.add_argument("--launch-rank", metavar="CFG", help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=CARDS_SECTIONS, action="append",
                    help="with --cards: run only these sections "
                         "(repeatable; default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no repro_torch package under {ROOT}/src; run "
              f"the script from the root of a checkout", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.shard_rank:                  # a rank of phase 3e's world
        return shard_rank(args.shard_rank)
    if args.dp_rank:                     # a rank of a phase-3i world
        return dp_rank(args.dp_rank)
    if args.tp_rank:                     # a rank of a phase-3j world
        return tp_rank(args.tp_rank)
    if args.fsdp_rank:                   # a rank of a phase-3k world
        return fsdp_rank(args.fsdp_rank)
    if args.launch_rank:                 # a rank of a phase-3l world
        return launch_rank(args.launch_rank)
    if args.cards:
        return sharded_across_cards(torch, args.cards,
                                    args.only or CARDS_SECTIONS)
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import env

    t_start = time.perf_counter()
    report = {"platform": env.platform_profile()}
    say(json.dumps({"platform": report["platform"]}))
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_build(torch, kernels, report)

    p22, s22, d22, _ = make_graph("rmat22.el", MAIN_SCALE, False, False, SEED)
    p18w, s18w, d18w, w18w = make_graph("rmat18w.el", SMALL_SCALE, True,
                                        False, SEED + 10)
    p18z, s18z, d18z, _ = make_graph("rmat18.el.gz", SMALL_SCALE, False,
                                     True, SEED + 20)
    v22 = int(max(s22.max(), d22.max())) + 1
    t0 = time.perf_counter()
    oracle22 = csr_oracle(s22, d22, None, v22)
    oracle18w = csr_oracle(s18w, d18w, w18w,
                           int(max(s18w.max(), d18w.max())) + 1)
    oracle18z = csr_oracle(s18z, d18z, None,
                           int(max(s18z.max(), d18z.max())) + 1)
    say(f"oracles in {time.perf_counter() - t0:.1f}s")

    runs = []
    for method in ("staged", "global", "binned"):
        runs.append(drive(torch, repro_torch, kernels, p22, method, False,
                          oracle22, len(s22), f"rmat22 {method}"))
    # the first load of the process also pays one-time costs (allocator
    # growth, pinned buffers); a second staged load shows the steady state
    runs.append(drive(torch, repro_torch, kernels, p22, "staged", False,
                      oracle22, len(s22), "rmat22 staged again"))
    runs.append(drive(torch, repro_torch, kernels, p18w, "staged", True,
                      oracle18w, len(s18w), "rmat18 weighted staged"))
    runs.append(drive(torch, repro_torch, kernels, p18z, "staged", False,
                      oracle18z, len(s18z), "rmat18 gzip staged"))
    report["runs"] = runs
    del oracle18w, oracle18z, s18w, d18w, w18w
    say("phase 3: every main-path CSR equals the numpy oracle bitwise")

    consumers = phase_consumers(torch, repro_torch, kernels, p22, s22,
                                oracle22, report)
    by_path, snap_paths = phase_snapshots(torch, repro_torch, kernels, p22,
                                          oracle22, consumers, report)
    inputs = phase_kernels(torch, repro_torch, kernels, p22, v22,
                           {r["method"]: r["launches"] for r in runs[:3]},
                           consumers, report)
    scan_row = phase_scan_kernel(torch, kernels, report)
    if args.parent:
        phase_parent(torch, kernels, args.parent, inputs, report)
    del inputs
    torch.cuda.empty_cache()
    phase_breakdown(torch, repro_torch, p22, report)
    phase_profile(torch, repro_torch, p22, report)
    del consumers
    # phase 3d runs on 3c's files after the traced phases: placed before
    # them, it left phase 4's first trace with no device record at all on
    # an H100 (PERF.md, section 6).  It swaps another graph's raw snapshot
    # in: the gzip scale-18 one.
    swap_path = os.path.join(DATA, "snapshots", "rmat18.gvel")
    repro_torch.open_graph(p18z).save(swap_path)
    # phase 3f serves 3c's raw snapshot after 3d has swapped it out: a
    # second link keeps its bytes
    served_snap = os.path.join(DATA, "snapshots", "rmat22.served.gvel")
    if os.path.exists(served_snap):
        os.remove(served_snap)
    os.link(snap_paths[""], served_snap)
    by_path.update(phase_serving(
        torch, repro_torch, kernels, p22, oracle22, snap_paths,
        (swap_path, csr_oracle(s18z, d18z, None,
                               int(max(s18z.max(), d18z.max())) + 1)),
        report))
    for p in snap_paths.values():
        os.remove(p)
    by_path.update(phase_sharded(torch, repro_torch, kernels, p22, oracle22,
                                 report))
    del oracle22
    by_path.update(phase_serve_lm(torch, repro_torch, kernels, served_snap,
                                  p22, report))
    by_path.update(phase_serve_kinds(torch, kernels, served_snap, p22,
                                     report))
    by_path.update(phase_train_lm(torch, kernels, p22, report))
    by_path.update(phase_train_dp(torch, kernels, p22, report))
    by_path.update(phase_tp(torch, kernels, p22, report))
    by_path.update(phase_fsdp(torch, kernels, p22, report))
    by_path.update(phase_launch(torch, kernels, report))
    by_path.update(phase_host_engines(torch, repro_torch, kernels, report))
    prefill = phase_recurrent_prefill(torch, kernels, served_snap, report)
    os.remove(served_snap)
    by_path.update(prefill)
    scan_row["launches"] = sum(c["linear_scan"] for c in prefill.values())
    for row in report["kernels"]:
        row["launches_by_path"] = {path: counts.get(row["name"], 0)
                                   for path, counts in by_path.items()}
    report["trace_losses"] = {
        "traces": len(TRACE_LOSSES),
        "traces_that_lost_records": sum(1 for _, lost in TRACE_LOSSES
                                        if lost),
        "launches": sum(n for n, _ in TRACE_LOSSES),
        "launches_without_a_record": sum(lost for _, lost in TRACE_LOSSES)}
    say(json.dumps({"trace_losses": report["trace_losses"]}))
    report["seconds"] = time.perf_counter() - t_start

    report["nvidia_smi"] = smi_line()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    say(json.dumps({"kernels": report["kernels"]}))
    say(report["nvidia_smi"] or "nvidia-smi: no output")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
