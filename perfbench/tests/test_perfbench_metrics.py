"""The metric arithmetic: rates, the p95, the roofline numerators and the
device's idle union."""

import importlib.util
import os

import pytest

from perfbench.lib import harness, peaks, trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(**kw):
    base = dict(cell=None, setup_s=12.5, window_s=10.0, latencies=[1.0] * 5, work=[2.0] * 5,
                counters={}, spans=harness.Spans(), trace=None, clock_hz=1.98e9)
    base.update(kw)
    return harness.Run(**base)


def test_rates_and_setup():
    r = run(work=[56.0, 56.0, 40.0], window_s=4.0)
    assert reader("sketch_mbp_per_s")(r) == pytest.approx(38.0)
    assert reader("gather_queries_per_s")(run(work=[1.0] * 7, window_s=2.0)) == 3.5
    assert reader("setup_s")(r) == 12.5


def test_p95():
    r = run(latencies=[float(i) for i in range(1, 101)])
    # Python's inclusive quantiles: 1 + 0.95 * 99
    assert reader("gather_p95_s.genomes")(r) == pytest.approx(95.05)


def test_span_metrics():
    s = harness.Spans()
    s.totals = {"parse": 2.0, "prefetch": 0.5, "schedule": 0.25, "rows": 1.0}
    r = run(spans=s, work=[500.0, 500.0])  # 1 Gbp
    assert reader("sketch_parse_ms_per_gbp")(r) == pytest.approx(2000.0)
    q = run(spans=s, work=[1.0] * 10)
    assert reader("gather_prefetch_ms_per_query")(q) == pytest.approx(50.0)
    assert reader("gather_schedule_ms_per_query")(q) == pytest.approx(25.0)
    assert reader("gather_rows_ms_per_query")(q) == pytest.approx(100.0)
    assert reader("sketch_copy_ms_per_gbp")(run()) is None  # no trace: nothing to read


def test_idle_union_and_reduce():
    dev = [("k1", 0, 10), ("k2", 5, 20), ("Memcpy HtoD (Pageable -> Device)", 30, 40),
           ("Memcpy DtoH (Device -> Pageable)", 90, 95), ("late", 200, 300)]
    host = [("window", 0, 100), ("request", 0, 100), ("parse", 20, 30), ("rows", 50, 90)]
    t = trace.reduce(dev, host)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(35e-6)  # [0,20] + [30,40] + [90,95]
    assert t.kernels_s == pytest.approx(25e-6) and t.kernel_launches == 2
    assert t.htod_s == pytest.approx(10e-6) and t.dtoh_s == pytest.approx(5e-6)
    gaps = dict(t.idle_gaps)
    # a gap is named by the innermost span at its middle: [20, 30] parse,
    # [40, 90] rows, [95, 100] request
    assert gaps["parse"] == pytest.approx(10e-6) and gaps["rows"] == pytest.approx(50e-6)
    assert gaps["request"] == pytest.approx(5e-6)
    r = run(trace=t)
    assert reader("device_idle_pct.sketch")(r) == pytest.approx(65.0)
    assert reader("device_idle_pct.gather")(r) == pytest.approx(65.0)


def test_roofline_numerators():
    # k = 31: one block and a 15-byte tail, four 8-byte halves. IMAD slots: two
    # multiplies a half (4 each), h * 5 + c for h1 and h2 (2 each), fmix's
    # four multiplies: 32 + 4 + 16. ALU-only: a rotate and a xor a half (4),
    # two rotates of the block (4), three shift-xors in each fmix (12), less
    # the two first xors of the zero seed halves. Either pipe: the block's
    # h1 += h2 and h2 += h1 less the first (2), the finish's 4, the last 2.
    assert peaks.int_ops_murmur(31) == (52, 30, 8)
    least, by = peaks.bound_s(3.35e12, 0, 0, 0, 1.98e9)
    assert least == pytest.approx(1.0) and by == "bytes"
    c = dict(ks=[31], scaled=1000, bases=10**9, windows_k31=10**9)
    t = trace.TraceSummary(kernels_s=1.0)
    pct = reader("sketch_kernels_roofline_pct")(run(counters=c, trace=t))
    imad, other, either = peaks.int_ops_per_window(31)
    ops_s = max(imad, other, (imad + other + either) / 2) * 1e9 / (132 * 64 * 1.98e9)
    assert pct == pytest.approx(100 * ops_s)
    g = dict(collection_hashes=341_000_000, query_hashes=600_000, members=85205)
    pct = reader("gather_kernels_roofline_pct")(run(counters=g, trace=trace.TraceSummary(kernels_s=0.01)))
    assert pct == pytest.approx(100 * (8 * 341_600_000 + 4 * 85205) / 3.35e12 / 0.01)
    assert reader("gather_kernels_roofline_pct")(run(counters=g)) is None
