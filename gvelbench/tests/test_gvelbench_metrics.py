"""The per-layer readers over a made-up trace of two profiled loads."""
import numpy as np
import pytest

from gvelbench import graphs, harness, roofline, trace

PARSE = "(anonymous namespace)::parse_accumulate_kernel(Geometry, ...)"


def load(offset, lost=0):
    # us: copy 0-10, parse 10-14, count copy 14-15, fill 2-3 (before the
    # last parse), build 20-26 and 30-31, a second copy 40-42
    recs = [("Memcpy HtoD (Pinned -> Device)", 0, 10), (PARSE, 10, 14),
            ("Memcpy DtoH (Device -> Pinned)", 14, 15),
            ("vectorized_elementwise_kernel<FillFunctor>", 2, 3),
            ("radixSortKVInPlace", 20, 26), ("scatter", 30, 31),
            ("Memcpy HtoD (Pinned -> Device)", 40, 42)]
    return {"span": (offset, offset + 100),
            "records": [(n, s + offset, e + offset) for n, s, e in recs],
            "launches": len(recs) + lost, "lost": lost,
            "gaps": [("x", 5e-5)]}


def data(profiled=None, loads_s=(0.5, 0.6, 0.7, 0.8, 0.9), window_s=3.6,
         cfg=None, weighted=False):
    ids = np.arange(10, dtype=np.int32)
    g = graphs.Graph(ids, ids, ids.astype(np.float32) if weighted else None)
    result = {"profiled": [load(0), load(1000)] if profiled is None
              else profiled, "loads_s": list(loads_s), "window_s": window_s}
    return harness.RunData(result, g, 1000, "NVIDIA H100 80GB HBM3", cfg)


def test_device_time_readers():
    d = data()
    assert d.value("parse_device_ms") == pytest.approx(0.004)
    # after the last parse record, copies excluded: 6 + 1 us
    assert d.value("build_device_ms") == pytest.approx(0.007)
    assert d.value("h2d_ms") == pytest.approx(0.012)
    # kernels and memsets, their union: 2-3, 10-14, 20-26, 30-31
    assert d.value("load_kernel_ms") == pytest.approx(0.012)
    busy, window = d.busy_window_s()
    # every record's union: 0-15, 20-26, 30-31, 40-42
    assert busy == pytest.approx(2 * (15 + 6 + 1 + 2) / 1e6)
    assert window == pytest.approx(2 * 100 / 1e6)
    assert d.value("device_idle_pct") == pytest.approx(100 - 24)


def test_a_load_that_lost_a_record_is_left_out():
    d = data([load(0, lost=1), load(1000)])
    assert len(d.loads) == 1
    assert d.value("parse_device_ms") == pytest.approx(0.004)
    busy, window = d.busy_window_s()
    assert window == pytest.approx(100 / 1e6)


def test_load_s_p75_is_the_exclusive_quartile():
    # five loads: the third quartile lies between the 4th and 5th
    assert data().value("load_s_p75") == pytest.approx(0.85)
    assert data(loads_s=(0.5, 0.6, 0.7)).value("load_s_p75") is None


def test_window_edges_per_s_is_all_the_loads_over_the_window():
    # five loads of ten edges in a 3.6 s window, not over the loads' sum
    assert data().value("window_edges_per_s") == pytest.approx(50 / 3.6)
    assert data(loads_s=()).value("window_edges_per_s") is None


def test_rooflines():
    d = data()
    least_parse = (1000 + 10 * 8) / 3.35e12 * 1e3
    assert d.value("parse_roofline") == pytest.approx(
        100 * least_parse / 0.004)
    least_build = (10 * 12 + 11 * 8) / 3.35e12 * 1e3
    assert d.value("build_roofline") == pytest.approx(
        100 * least_build / 0.007)


def config(name):
    """A configuration of the benchmark or of its spare cells."""
    from gvelbench.tests import spare
    files = {c["name"]: c["file"] for c in spare.bench()["configs"]}
    return harness.read_json(harness.ROOT / files[name])


@pytest.mark.parametrize("name", ["graph500-s22", "gap-urand-s22-w"])
def test_a_directed_configuration_reads_as_before(name):
    # the readers' formulas before configurations stated their symmetry,
    # compared exactly
    cfg = config(name)
    weighted = cfg["weights"] != "none"
    d = data(cfg=cfg, weighted=weighted)
    assert d.product_edges == d.edges == 10
    peak = 3.35e12
    assert d.value("build_roofline") == 100.0 * (
        roofline.build_bytes(10, 10, weighted) / peak * 1e3) / 0.007
    assert d.value("parse_roofline") == 100.0 * (
        roofline.parse_bytes(1000, 10, weighted) / peak * 1e3) / 0.004
    assert d.value("window_edges_per_s") == 5 * 10 / 3.6


def test_a_symmetric_build_counts_the_edges_it_holds():
    # the spare GAP file loaded symmetric: the build places 2E edges, the
    # parse still reads E lines and the rate counts the file's edges
    cfg = config("gap-urand-s22-wsym")
    assert cfg["symmetric"] is True
    d = data(cfg=cfg, weighted=True)
    assert (d.edges, d.product_edges) == (10, 20)
    least_build = (20 * (12 + 8) + 11 * 8) / 3.35e12 * 1e3
    assert d.value("build_roofline") == pytest.approx(
        100 * least_build / 0.007)
    directed = data(cfg=config("gap-urand-s22-w"), weighted=True)
    for name in ("parse_roofline", "window_edges_per_s"):
        assert d.value(name) == directed.value(name)


def test_card_work_leaves_out_copies():
    names = [n for n, _, _ in load(0)["records"]]
    assert [trace.is_card_work(n) for n in names] == \
        [False, True, False, True, True, True, False]
    work = [(s, e) for n, s, e in load(0)["records"]
            if trace.is_card_work(n)]
    assert trace.covered(work) == 4 + 1 + 6 + 1
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_unclaimed_and_breakdown():
    d = data()
    claimers = []
    for m in harness.benchmark()["per_layer"]:
        mod = d.module(m["name"])
        if hasattr(mod, "make_claim"):
            claimers.append(mod.make_claim(d))
        elif hasattr(mod, "claim"):
            claimers.append(mod.claim)
    left = harness.unclaimed(d, claimers)
    assert set(left) == {"Memcpy DtoH (Device -> Pinned)",
                         "vectorized_elementwise_kernel<FillFunctor>"}
    b = harness.breakdown(d)
    assert b["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)",
                                  pytest.approx(1.2e-5)]
    assert b["idle_gaps"] == [["x", pytest.approx(5e-5)]]


def test_nothing_to_read_gives_nothing():
    ids = np.arange(3, dtype=np.int32)
    g = graphs.Graph(ids, ids, None)
    d = harness.RunData({"profiled": [], "loads_s": []}, g, 10, "cpu")
    for m in harness.benchmark()["per_layer"]:
        assert d.value(m["name"]) is None


GATHER = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
SENDRECV = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"


def rank_load(rank, offset):
    # us: parse 10-14, the vertex count 15-16, a copy 16-17, the histogram
    # 17-18, a gather 19-20, the one-hot cumsum 21-23, a gather 24-25, the
    # exchange 26-30 (rank 1's starts later), the build 31-35
    late = 2 if rank else 0
    recs = [(PARSE, 10, 14), ("reduce_kernel", 15, 16),
            ("Memcpy DtoH (Device -> Pinned)", 16, 17),
            ("bincount", 17, 18), (GATHER, 19, 20), ("cumsum", 21, 23),
            (GATHER, 24, 25), (SENDRECV, 26 + late, 30),
            ("radixSortKVInPlace", 31, 35)]
    return {"span": (offset, offset + 50), "rank": rank,
            "records": [(n, s + offset, e + offset) for n, s, e in recs],
            "launches": len(recs), "lost": 0, "gaps": []}


def sharded(exchange_bytes=450_000):
    ids = np.arange(10, dtype=np.int32)
    result = {"profiled": [rank_load(0, 0), rank_load(1, 0),
                           rank_load(0, 100), rank_load(1, 100)],
              "loads_s": [0.5], "window_s": 1.0,
              "exchange_bytes": exchange_bytes}
    return harness.RunData(result, graphs.Graph(ids, ids, None), 1000,
                           "NVIDIA H100 80GB HBM3")


def test_sharded_readers():
    d = sharded()
    # NCCL: 1 + 1 + 4 us on rank 0, 1 + 1 + 2 on rank 1
    assert d.value("exchange_device_ms") == pytest.approx(0.005)
    # 450 kB over 450 GB/s: 1 us of the 5
    assert d.value("exchange_roofline") == pytest.approx(20.0)
    # from 14 to the exchange, NCCL and the copy out: 1 + 1 + 2 us
    assert d.value("bucket_device_ms") == pytest.approx(0.004)
    assert d.value("parse_device_ms") == pytest.approx(0.004)
    # busy 10-14, 15-18, 19-20, 21-23, 24-25, 26-30, 31-35 = 19 us of a
    # load's 50 on rank 0, 17 on rank 1; two loads a card, over two cards
    busy, window = d.busy_window_s()
    assert busy == pytest.approx((2 * 19 + 2 * 17) / 2 / 1e6)
    assert window == pytest.approx(2 * 50 / 1e6)
    assert d.value("device_idle_pct") == pytest.approx(100 * (1 - 18 / 50))
    assert sharded(None).value("exchange_roofline") is None


def test_bucketing_needs_a_parse_and_an_exchange():
    d = data()
    assert d.value("bucket_device_ms") is None
    assert d.value("exchange_device_ms") is None


class Event:
    """A kineto event as ``trace._raw`` reads it."""

    def __init__(self, name, card, start_us, end_us, corr, note=False):
        self._v = (name, card, start_us, end_us, corr, note)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return int(self._v[2] * 1000)

    def duration_ns(self):
        return int((self._v[3] - self._v[2]) * 1000)

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class Profile:
    def __init__(self, events):
        class Results:
            def events(_):
                return events

        class Profiler:
            kineto_results = Results()
        self.profiler = Profiler()


def test_a_range_image_never_takes_a_launchs_record():
    pytest.importorskip("torch")
    events = [Event("gvelbench.load.0", False, 0, 100, 7, note=True),
              Event("cudaLaunchKernel", False, 10, 11, 9),
              Event("cudaLaunchKernel", False, 20, 21, 7),
              Event("parse", True, 12, 14, 9),
              Event("build", True, 22, 25, 7),
              # the range's card image shares its id, 7, with a launch
              Event("gvelbench.load.0", True, 0, 100, 7, note=True),
              Event("marker", True, 40, 90, 11, note=True)]
    (ld,) = trace.collect(Profile(events))
    assert ld["records"] == [("parse", 12, 14), ("build", 22, 25)]
    assert ld["launches"] == 2 and ld["lost"] == 0
