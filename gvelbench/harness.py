"""One run of one cell: set-up, the measured window, the traced loads, the
reference, and the result line.

A cell names a configuration (``configs/<name>.json``: the graph and its
generator) and a traffic mix (``traffic/<name>.json``: which product of
the front door a load asks for, and on how many ``ranks``).  Each load is
a fresh ``repro_torch.open_graph(path)`` handle, since a handle memoizes
its products, and ends in ``torch.cuda.synchronize()``; loads run back to
back, one client, a closed loop, on one card, or on one card a rank with
every rank loading together (:mod:`.ranks`; the loads are rank 0's and the
peak the fullest card's).

The window runs without the profiler.  Its end-to-end metrics are the
card's peak allocation over its loads, ``peak_device_gib``, and the
set-up before it, ``setup_s``; its load rate, the edges of every load it
completes over its seconds on the host's clock, moves with the host's
speed by more than any permitted bound and is a per-layer metric
(``window_edges_per_s``).  With ``--trace 1`` a few more loads run under
the profiler after the window, for the per-layer metrics.

Each per-layer metric is a reader in ``metrics/<name>.py`` with
``read(run) -> float | None`` over a :class:`RunData`; a reader that
measures one layer's device time also has ``claim(record, load) -> bool``
(or ``make_claim(run)`` returning one), which the harness uses to print
the device time that no layer claims.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import graphs, reference, roofline, shards, trace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level names, whole
PROFILED_LOADS = 4
CHECKED_FROM = 4          # the checked load is drawn from the first four
STREAM_CHECKED = 2        # graphs.py uses streams 0 and 1


class BenchError(RuntimeError):
    """A run that cannot produce a result."""


class NoDevice(BenchError):
    """Fewer CUDA devices than the cell asks for."""


def read_json(path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


def cell_parts(bench: Dict, name: str):
    """``(cell, config, traffic)`` of the workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    files = {c["name"]: ROOT / c["file"] for c in bench["configs"]}
    return (cell, read_json(files[cell["config"]]),
            read_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def import_program():
    """The port, from the checkout's ``src``."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch
    return repro_torch


# ---------------------------------------------------------------------------
# one load through the front door
# ---------------------------------------------------------------------------

class FrontDoor:
    """Callable: one load of the traffic's product, complete on return."""

    def __init__(self, torch, repro_torch, traffic: Dict, cfg: Dict,
                 path: str, device, mesh=None):
        self.torch, self.rt = torch, repro_torch
        self.traffic = traffic
        self.product = traffic["product"]
        self.method = traffic.get("method")
        self.path, self.device, self.mesh = path, device, mesh
        self.weighted = cfg["weights"] != "none"

    def __call__(self):
        g = self.rt.open_graph(self.path, weighted=self.weighted,
                               device=self.device)
        if self.product == "csr":
            out = g.csr(method=self.method)
        elif self.product == "edgelist":
            out = g.edgelist()
        elif self.product == "csr_sharded":
            out = g.csr_sharded(self.mesh, axis=self.traffic["axis"],
                                rho=self.traffic["rho"], method=self.method)
        else:
            raise BenchError(f"unknown product {self.product!r}")
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        return out

    def to_host(self, out) -> Dict:
        def host(t):
            return None if t is None else t.cpu().numpy()
        if self.product == "edgelist":
            return {"src": host(out.src), "dst": host(out.dst),
                    "weights": host(out.weights),
                    "num_vertices": out.num_vertices}
        offsets = host(out.offsets)
        n = int(offsets[-1]) if len(offsets) else 0
        rows = {"offsets": offsets, "targets": host(out.targets[:n]),
                "weights": None if out.weights is None
                else host(out.weights[:n]),
                "num_vertices": out.num_vertices}
        if self.product == "csr_sharded":
            rows["row_start"] = out.row_start
        return rows


# ---------------------------------------------------------------------------
# the loads: warm-up, the window, the traced loads
# ---------------------------------------------------------------------------

def run_loads(spec: Dict) -> Dict:
    """Set-up's warm load, the window and the traced loads, in this process
    or, where ``spec`` has ``ranks``, as this process's rank of the world
    (:mod:`.ranks`).  ``spec``: ``path``, ``cfg``, ``traffic``,
    ``seconds``, ``trace``, ``checked`` (the index of the window's load to
    check besides the last), ``device`` (``cuda`` | ``cpu``), ``patch``
    (``module:function`` run first; tests only); a rank's also ``ranks``
    and ``init``, the rendezvous file.  Rank 0 decides when the window
    ends, and every rank copies the same loads' rows."""
    stamps = {"loads_start": time.monotonic()}
    if spec.get("patch"):
        mod, fn = spec["patch"].split(":")
        getattr(importlib.import_module(mod), fn)()
    import torch
    rt = import_program()
    from repro_torch.kernels import _lib
    cuda = spec["device"] == "cuda"
    d, rank, world = spec.get("ranks", 1), 0, None
    if d > 1:
        from .ranks import World
        rank = int(os.environ["RANK"])
        if cuda:
            torch.cuda.set_device(rank)
        world = World(spec["device"], spec["traffic"]["axis"], spec["init"])
        stamps["joined"] = time.monotonic()
        while not os.path.exists(spec["path"]):    # the parent writes it
            time.sleep(0.05)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    load = FrontDoor(torch, rt, spec["traffic"], spec["cfg"], spec["path"],
                     device, mesh=world and world.mesh)
    expected = shards.parse_batches(os.path.getsize(spec["path"]),
                                    spec["cfg"], d)[rank]
    off_loads: List[int] = []
    made = 0

    def counted():
        nonlocal made
        before = _lib.LAUNCHES["parse_accumulate"]
        out = load()
        if _lib.LAUNCHES["parse_accumulate"] - before != expected:
            off_loads.append(made)
        made += 1
        return out

    counted()                             # the cell's shapes, once
    if world is not None:
        world.barrier()
    stamps["warmed"] = time.monotonic()
    window_start = time.monotonic()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    loads, checked = [], {}
    paused = 0.0              # the checked load's copy to the host
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        out = counted()
        t1 = time.perf_counter()
        loads.append(t1 - t0)
        stop = t1 - t_start - paused >= spec["seconds"]
        if world is not None:
            stop = world.agree(stop)
        if stop:
            break
        if i == spec["checked"]:
            checked[i] = load.to_host(out)
            if world is not None:
                world.barrier()
            paused += time.perf_counter() - t1
        del out
        i += 1
    window_s = t1 - t_start - paused
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    checked[i] = load.to_host(out)
    del out
    profiled = []
    if spec["trace"] and cuda:
        with trace.profiled(torch) as prof:
            for j in range(PROFILED_LOADS):
                with trace.load_range(torch, j):
                    out = counted()
                del out
        profiled = trace.collect(prof)
        for ld in profiled:
            ld["rank"] = rank
    if world is not None:
        world.close()
    return {"rank": rank, "loads_s": loads, "window_s": window_s,
            "window_start": window_start, "peak_bytes": peak,
            "checked": checked, "off_loads": off_loads,
            "off_launches": len(off_loads), "expected_launches": expected,
            "attempted": made, "profiled": profiled, "stamps": stamps,
            "device_name": torch.cuda.get_device_name(device) if cuda
            else "cpu"}


# ---------------------------------------------------------------------------
# the run's data, for the per-layer readers
# ---------------------------------------------------------------------------

def _load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"gvelbench_metric_{path.stem.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class RunData:
    """What a per-layer reader reads: the profiled loads (``loads``, a
    list of :mod:`.trace` load dicts, each rank's of a sharded cell with
    its ``rank``; a load that lost a device record is left out), the
    window's ``loads_s`` and ``window_s`` on the host's clock, the graph's
    ``file_bytes``, ``edges``, ``num_vertices`` and ``weighted``, the
    card's ``kind`` and ``peak_bytes_per_s``, and in a sharded cell the
    least ``exchange_bytes`` of the busiest card (:mod:`.shards`)."""

    def __init__(self, result: Dict, graph: graphs.Graph, file_bytes: int,
                 kind: str):
        self.loads = [ld for ld in result["profiled"] if not ld["lost"]]
        self.loads_s = list(result["loads_s"])
        self.window_s = result.get("window_s")
        self.exchange_bytes = result.get("exchange_bytes")
        self.kind = kind
        self.file_bytes = file_bytes
        self.edges = graph.num_edges
        self.num_vertices = reference.vertex_count(graph.src, graph.dst)
        self.weighted = graph.weights is not None
        self.peak_bytes_per_s = (roofline.peak_bytes_per_s(kind)
                                 if self.loads else None)
        self._modules: Dict[str, object] = {}
        self._values: Dict[str, Optional[float]] = {}

    def module(self, name: str):
        if name not in self._modules:
            self._modules[name] = _load_module(HERE / "metrics" /
                                               f"{name}.py")
        return self._modules[name]

    def value(self, name: str) -> Optional[float]:
        """Metric ``name``'s reading of this run (None: nothing to read)."""
        if name not in self._values:
            v = self.module(name).read(self)
            self._values[name] = None if v is None else float(v)
        return self._values[name]

    def device_ms(self, claim: Callable) -> Optional[float]:
        """Device ms a load of the records ``claim`` takes, summed, over the
        whole profiled loads; None without one or a claimed record."""
        if not self.loads:
            return None
        ms = sum((e - s) for ld in self.loads for (n, s, e) in ld["records"]
                 if claim((n, s, e), ld)) / len(self.loads) / 1e3
        return ms or None

    def covered_ms(self, keep: Callable[[str], bool]) -> Optional[float]:
        """Device ms a load in which a record whose name ``keep`` takes
        runs: the union of their intervals, over the whole profiled
        loads."""
        if not self.loads:
            return None
        ms = sum(trace.covered([(s, e) for n, s, e in ld["records"]
                                if keep(n)])
                 for ld in self.loads) / len(self.loads) / 1e3
        return ms or None

    def busy_window_s(self):
        """``(busy, window)`` seconds over the whole profiled loads, averaged
        over the cards: the union of each load's records on its card, and
        the loads' host spans."""
        cards = len({ld.get("rank", 0) for ld in self.loads}) or 1
        busy = sum(trace.covered([(s, e) for _, s, e in ld["records"]])
                   for ld in self.loads) / 1e6 / cards
        window = sum(ld["span"][1] - ld["span"][0] for ld in self.loads) \
            / 1e6 / cards
        return busy, window


def unclaimed(run: RunData, claimers) -> Dict[str, float]:
    """Device ms a load by record name that no reader claims."""
    out: Dict[str, float] = {}
    n = len(run.loads) or 1
    for ld in run.loads:
        for rec in ld["records"]:
            if not any(c(rec, ld) for c in claimers):
                out[rec[0]] = out.get(rec[0], 0.0) + (rec[2] - rec[1]) \
                    / 1e3 / n
    return out


def breakdown(run: RunData) -> Dict:
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    n = len(run.loads) or 1
    for ld in run.loads:
        for name, s, e in ld["records"]:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6 / n
        for what, sec in ld["gaps"]:
            gaps[what] = gaps.get(what, 0.0) + sec / n

    def top(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


# ---------------------------------------------------------------------------
# the whole run
# ---------------------------------------------------------------------------

def checked_index(seed: int) -> int:
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed % (1 << 64), STREAM_CHECKED]))
    return int(rng.integers(0, CHECKED_FROM))


def compare(result: Dict, graph: graphs.Graph, traffic: Dict
            ) -> Dict[str, int]:
    """The numbers compared, each with the limit 0."""
    g = graph
    v = reference.vertex_count(g.src, g.dst)
    counts = []
    if traffic["product"] == "edgelist":
        for got in result["checked"].values():
            counts.append(reference.compare_edges(got, g.src, g.dst,
                                                  g.weights, v))
    elif traffic["product"] == "csr_sharded":
        want = reference.shard_rows(reference.csr(g.src, g.dst, g.weights,
                                                  v), traffic["ranks"])
        for got in result["checked"].values():
            counts.append(reference.compare_shards(got, want,
                                                   g.weights is not None))
        del want
    else:
        ref = reference.csr(g.src, g.dst, g.weights, v)
        for got in result["checked"].values():
            counts.append(reference.compare_csr(got, ref,
                                                g.weights is not None, v))
        del ref
    out = reference.worst(counts)
    out["loads_off_launches"] = result["off_launches"]
    return out


def nvidia_smi() -> Optional[str]:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    p = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return p.stdout.strip().replace("\n", "; ") or None


def _prepare(name: str, chips: int, t0: float, say) -> None:
    """Import torch and the port, look for the card, build the kernels."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card "
                       "and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{name} needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} here")
    import_program()
    from repro_torch.kernels import _lib
    _lib.build()
    say(f"torch, the port and its kernels ready by "
        f"{time.monotonic() - t0:.3f} s")


def run(name: str, seed: int, seconds: float, trace_on: bool, *,
        t0: float, device: str = "cuda", cfg_override: Optional[Dict] = None,
        patch: Optional[str] = None, say=print):
    """One run of cell ``name``: ``(result, forbidden)``, the result line's
    object and the forbidden modules loaded.  ``cfg_override`` replaces
    keys of the configuration (tests run scale 10 on the CPU with it).
    The graph is made while torch and the port import; a sharded cell's
    ranks start once the kernels are built and wait for it."""
    from . import ranks
    bench = benchmark()
    cell, cfg, traffic = cell_parts(bench, name)
    cfg = dict(cfg, **(cfg_override or {}))
    d = traffic.get("ranks", 1)
    if d != cell["chips"]:
        raise BenchError(f"{name}: the traffic runs {d} rank(s), the cell "
                         f"asks for {cell['chips']} chips")
    tmp = tempfile.mkdtemp(prefix="gvelbench_")
    path = os.path.join(tmp, "graph.el")
    spec = {"path": path, "cfg": cfg, "traffic": traffic,
            "seconds": seconds, "trace": trace_on,
            "checked": checked_index(seed), "device": device,
            "patch": patch}
    world = ranks.Ranks(spec, d, tmp) if d > 1 else None

    def prepare():
        if device == "cuda":
            _prepare(name, cell["chips"], t0, say)
        if world is not None:
            world.start()

    pool = ThreadPoolExecutor(1)
    try:
        prep = pool.submit(prepare)
        graph = graphs.make(cfg, seed, path)
        file_bytes = os.path.getsize(path)
        say(f"graph {cfg['name']} seed {seed}: {graph.num_edges} edges, "
            f"{file_bytes} bytes, written by {time.monotonic() - t0:.3f} s")
        prep.result()
        r = run_loads(spec) if world is None else world.wait()
    finally:
        if world is not None:
            world.stop()
        pool.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    if trace_on and d > 1:
        r["exchange_bytes"] = roofline.exchange_bytes(
            shards.moves(graph, cfg, file_bytes, d,
                         reference.vertex_count(graph.src, graph.dst)),
            graph.weights is not None)
    loads = r["loads_s"]
    say("set-up, s from the start: " + json.dumps(
        {k: round(v - t0, 3) for k, v in r["stamps"].items()}))
    say(f"loads in the window: {len(loads)} in {r['window_s']:.4f} s, "
        f"{len(loads) * graph.num_edges / r['window_s']:.1f} edges/s; "
        f"parse launches a load {r['expected_launches']}")
    say("load s: " + json.dumps([round(x, 4) for x in loads]))
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": r["device_name"], "count": d,
                   "memory_peak_bytes": r["peak_bytes"]}
    extra = {}
    if trace_on:
        data = RunData(r, graph, file_bytes, r["device_name"])
        metrics = _per_layer(bench, name, data, r, say)
        device_info["busy_s"], device_info["window_s"] = \
            data.busy_window_s()
        extra["breakdown"] = breakdown(data)
    else:
        metrics = _end_to_end(bench, name, r, r["window_start"] - t0)
    smi = nvidia_smi() if device == "cuda" else None
    if smi:
        device_info["nvidia_smi"] = smi
    checks = compare(r, graph, traffic)
    result = {"correct": all(v == 0 for v in checks.values()),
              "attempted": r["attempted"], "failed": r["off_launches"],
              "metrics": metrics, "device": device_info, **extra,
              "checks": {k: {"value": v, "limit": 0}
                         for k, v in checks.items()}}
    return result, sorted(set(forbidden_modules()) |
                          set(r.get("forbidden", ())))


def _end_to_end(bench: Dict, name: str, r: Dict,
                setup_s: float) -> Dict[str, Dict]:
    values = {"peak_device_gib": r["peak_bytes"] / 2 ** 30,
              "setup_s": setup_s}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in bench["end_to_end"] if applies(m, name)}


def _per_layer(bench: Dict, name: str, data: RunData, r: Dict,
               say) -> Dict[str, Dict]:
    say("profiled loads, launches without a record: " + str(
        [ld["lost"] for ld in r["profiled"]]))
    metrics, claimers = {}, []
    for m in bench["per_layer"]:
        if not applies(m, name):
            continue
        v = data.value(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        mod = data.module(m["name"])
        if hasattr(mod, "make_claim"):
            claimers.append(mod.make_claim(data))
        elif hasattr(mod, "claim"):
            claimers.append(mod.claim)
    say("device ms a load that no layer claims: " + json.dumps(
        unclaimed(data, claimers)))
    return metrics
