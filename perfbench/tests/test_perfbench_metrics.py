"""Each metric reader, and the trace reduction, on synthetic runs."""
import math
from pathlib import Path

import pytest

from perfbench import harness, spec, trace, yardstick

METRICS = Path(__file__).resolve().parents[1] / "metrics"

M = {"n_layers": 2, "d_model": 8, "head_dim": 2, "n_heads": 4,
     "n_kv_heads": 2, "d_ff": 16, "vocab": 32, "gated_mlp": False}


def _read(name, w):
    return spec.reader(METRICS, name)(w)


def _window(**kw):
    base = dict(seconds=2.0, setup_s=30.5, model=M, generated=50,
                completions=[
                    {"latency": 1.0, "error": None,
                     "result": {"latency_s": 0.9, "ttft_s": 0.1}},
                    {"latency": 3.0, "error": None,
                     "result": {"latency_s": 2.95, "ttft_s": 0.3}},
                    {"latency": 9.0, "error": RuntimeError(), "result": None}],
                stats={"decode_tokens": 40, "decode_steps": 10,
                       "prefill_tokens": 30, "prefix_cached_tokens": 10},
                chunks=[(0, 4, True)], steps=[[4, 7]])
    base.update(kw)
    return harness.Window(**base)


def test_host_and_counter_readers():
    w = _window()
    assert _read("gen_tokens_per_s", w) == 25.0
    assert _read("setup_s", w) == 30.5
    assert _read("request_p95_s", w) == pytest.approx(1.0 + 0.95 * 2.0)
    assert _read("ttft_p95_s", w) == pytest.approx(0.1 + 0.95 * 0.2)
    assert _read("middleware_ms", w) == pytest.approx(75.0)
    assert _read("decode_batch", w) == 4.0
    assert _read("prefix_hit_share", w) == 25.0


def test_readers_return_nothing_without_data():
    w = _window(completions=[], stats=dict.fromkeys(
        ("decode_tokens", "decode_steps", "prefill_tokens",
         "prefix_cached_tokens"), 0), chunks=[], steps=[])
    for name in ("request_p95_s", "ttft_p95_s", "middleware_ms",
                 "decode_batch", "prefix_hit_share", "mfu",
                 "paged_decode_roofline", "idle_pct"):
        assert _read(name, w) is None, name


def test_mfu_counts_the_used_work():
    # per layer: attention 8*8 + 2*8*4 + 8*8 = 192, MLP 2*8*16 = 256
    weights = 2 * 2 * (192 + 256)
    attn = 4 * 2 * 4 * 2  # 4 * D * Hq * layers, a context position
    un = 2 * 8 * 32
    chunk = 4 * weights + attn * (1 + 2 + 3 + 4) + un
    step = 2 * (weights + un) + attn * (5 + 8)
    assert yardstick.window_flops(M, [(0, 4, True)], [[4, 7]]) == chunk + step
    want = 100 * (chunk + step) / (2.0 * yardstick.PEAK_BF16_FLOPS)
    assert _read("mfu", _window()) == pytest.approx(want)


def test_paged_decode_bytes_match_the_kernel_cost_formula():
    # 2 rows, Hq 8, Hkv 2, D 4, bf16, a 2 x 3 table, 10 attended
    assert yardstick.paged_decode_bytes(2, 8, 2, 4, 2, 6, 10) == (
        10 * 2 * 4 * 2 * 2 + 2 * 2 * 8 * 4 * 2 + 6 * 4 + 2 * 4)


# device: (name, start, end, correlation, linked); host: (name, start,
# end, thread, correlation, kind)
DEVICE = [("gemm", 100, 200, 1, 10), ("gemm", 150, 260, 2, 10),
          ("decode", 400, 450, 3, 20), ("copy", 700, 800, 4, 30)]
HOST = [("aten::mm", 90, 140, 7, 10, "op"),
        ("cudaLaunchKernel", 95, 99, 7, 1, "runtime"),
        ("cudaLaunchKernel", 120, 125, 7, 2, "runtime"),
        ("perfbench.paged_decode", 300, 390, 7, 20, "op"),
        ("cudaLaunchKernel", 350, 360, 7, 3, "runtime"),
        ("aten::copy_", 600, 690, 7, 30, "op"),
        ("cudaMemcpyAsync", 650, 690, 7, 4, "runtime")]


def test_busy_union_and_idle_gaps():
    assert trace.busy_ns(DEVICE) == 160 + 50 + 100
    gaps = dict(trace.idle_gaps(DEVICE, HOST))
    # 260-400: midpoint 330 inside the decode range; 450-700: midpoint 575
    # covered by nothing on the launching thread
    assert gaps == {"perfbench.paged_decode": 140e-9,
                    trace.NO_HOST_OP: 250e-9}
    assert trace.device_ops(DEVICE)[0] == ["gemm", 210e-9]


def test_range_device_time_by_launch_or_link():
    assert trace.range_device_ns(DEVICE, HOST, "perfbench.paged_decode") \
        == (50, 1)
    # no runtime event: the profiler's link to the range still counts
    host = [h for h in HOST if h[5] != "runtime"]
    assert trace.range_device_ns(DEVICE, host, "perfbench.paged_decode") \
        == (50, 1)
    assert trace.range_device_ns(DEVICE, HOST, "absent") == (0, 0)


def test_trace_readers():
    tr = {"window_s": 1.0, "busy_s": 0.25, "kernels": 4,
          "ranges": {"perfbench.paged_decode": {"device_s": 1e-3,
                                                "launches": 2}},
          "decode_bytes": 1.675e9}
    w = _window(trace=tr)
    assert _read("idle_pct", w) == 75.0
    assert _read("paged_decode_roofline", w) == pytest.approx(
        100 * 1.675e9 / 3.35e12 / 1e-3)
    assert math.isclose(_read("paged_decode_roofline", w), 50.0)

