"""``perfbench/tools/span_breakdown.py``: the interval arithmetic on
synthetic trace tuples, the middleware split on a synthetic window, and one
traced tiny run read through the program's spans."""
import pytest
import torch

from perfbench import trace
from perfbench.tests import tiny_root
from perfbench.tools import span_breakdown as sb

SEED = 2 ** 31 + 53


def test_interval_intersection_and_overlap():
    a = [[0, 10], [20, 30]]
    b = [[5, 25], [28, 40]]
    assert sb.intersect_ns(a, b) == 5 + 5 + 2
    assert sb.intersect_ns(a, []) == 0
    starts = [x[0] for x in a]
    assert sb.overlap_ns(a, starts, 8, 22) == 2 + 2
    assert sb.overlap_ns(a, starts, 11, 19) == 0
    assert sb.overlap_ns(a, starts, -5, 50) == 20


def _host(name, s, e):
    # a range's own correlation id, which no kernel here is linked to
    return (name, s, e, 1, 1000 + s, "op")


def test_reduce_splits_device_and_idle_time_by_span():
    # device busy [0,100] and [150,300]; the unembedding's kernel is
    # launched inside model/unembed, nested in engine/extend
    device = [("gemm", 0, 100, 7, -1), ("unembed_gemm", 150, 300, 8, -1)]
    host = [_host("servicer/step", 0, 400),
            _host("engine/step", 0, 120),
            _host("engine/extend", 0, 110),
            _host("engine/step", 130, 310),
            _host("engine/decode", 140, 305),
            _host("model/unembed", 145, 160),
            ("cudaLaunchKernel", 10, 11, 1, 7, "runtime"),
            ("cudaLaunchKernel", 150, 151, 1, 8, "runtime")]
    out = sb.reduce(device, host, window_s=400e-9, prefill_tokens=4)
    assert out["busy_s"] == pytest.approx(250e-9)
    assert out["idle_pct"] == pytest.approx(37.5)
    assert out["spans"]["model/unembed"]["device_s"] == pytest.approx(150e-9)
    assert out["spans"]["engine/extend"]["launches"] == 1
    # the work chosen is trace.range_device_ns's
    for name in sb.SPANS:
        ns, n = trace.range_device_ns(device, host, name)
        assert out["spans"][name]["device_s"] == pytest.approx(ns / 1e9)
        assert out["spans"][name]["launches"] == n
    # kernels whose stamps overlap count once inside a span, as in busy
    over = device + [("copy", 250, 320, 9, -1)]
    launch = host + [("cudaMemcpyAsync", 152, 153, 1, 9, "runtime")]
    decode = sb.reduce(over, launch, window_s=400e-9)["spans"]
    assert decode["engine/decode"]["device_s"] == pytest.approx(170e-9)
    assert decode["engine/decode"]["launches"] == 2
    assert out["unembed_share"] == pytest.approx(60.0)
    assert out["extend_us_per_token"] == pytest.approx(1e6 * 100e-9 / 4)
    # step 1 idle 120-100, step 2 idle 150-130 + 310-300
    assert out["step_idle_ms"] == pytest.approx((20 + 30) / 2 / 1e6)
    split = out["idle_split_s"]  # the one gap, [100, 150]
    assert split["gaps"] == pytest.approx(50e-9)
    assert split["engine/step"] == pytest.approx(40e-9)
    assert split["servicer/step only"] == pytest.approx(10e-9)
    assert split["outside"] == pytest.approx(0.0)
    # nothing on the device, no tokens: the shares read nothing
    empty = sb.reduce([], host, window_s=1.0)
    assert empty["unembed_share"] is None
    assert empty["extend_us_per_token"] is None


def test_middleware_split_means():
    done = [{"latency": 0.100, "result": {"latency_s": 0.050,
                                          "handoff_s": 0.040,
                                          "queue_s": 0.001}},
            {"latency": 0.200, "result": {"latency_s": 0.120,
                                          "handoff_s": 0.060,
                                          "queue_s": 0.003}},
            {"latency": 5.0, "result": None}]
    out = sb.middleware(done)
    assert out["middleware"] == pytest.approx(65.0)
    assert out["handoff"] == pytest.approx(50.0)
    assert out["queue"] == pytest.approx(2.0)
    assert out["delivery"] == pytest.approx(15.0)
    # results of a program without the stamps
    old = sb.middleware([{"latency": 0.1, "result": {"latency_s": 0.05}}])
    assert old["handoff"] is None and old["delivery"] is None
    assert old["middleware"] == pytest.approx(50.0)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_traced_tiny_run_is_read_by_its_spans(tmp_path, one_thread):
    root = tiny_root.make(tmp_path)
    out = sb.breakdown(root, "t.dense", SEED, 1.0, device="cpu")
    assert out["correct"]
    spans = out["spans"]
    for name in sb.SPANS:
        assert spans[name]["ranges"] > 0, name
    # no card: no device time, every step's whole length is idle
    assert out["busy_s"] == 0 and out["unembed_share"] is None
    assert out["step_idle_ms"] == pytest.approx(
        1e3 * spans["engine/step"]["host_s"] / spans["engine/step"]["ranges"])
    mw = out["middleware_ms"]
    assert mw["handoff"] >= 0 and mw["queue"] >= 0
    assert mw["middleware"] == pytest.approx(mw["handoff"] + mw["delivery"])
