"""One run of one cell: the program served through Rhapsody under a closed
loop of clients, measured for a window, then judged by the reference.

The entry the window drives is the program's served path, unchanged:
``Rhapsody.add_service(ServiceDescription(factory=llm_service_factory(...)))``
-> ``ReplicaSet.request`` -> its ``ServiceInstance`` thread ->
``LLMServicer`` -> the paged ``InferenceEngine`` -> the model's extend and
paged decode -> the paged decode kernel.  From outside the harness only
records what the engine scheduled (``recorder.Recorder``) and, in a traced
run, starts and stops ``torch.profiler`` in the engine's thread and marks
each call of the paged decode attention with a ``record_function`` range.

The clients are driven from this one thread: each future's completion is
queued and the client's next request sent from here, so the client books
take no time from the engine thread.  A run: the weights, made on the
device from the seed; the service; a warm-up of every prompt-chunk bucket
and decode batch size the mix reaches; ``ramp_seconds`` of the loop; the
measured window; the service stopped; the program's state freed; the
reference's check.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import queue
import threading
import time

import numpy as np
import torch

from perfbench import check, spec as specs, traffic, weights, yardstick
from perfbench import trace as tracing
from perfbench.recorder import Recorder, pow2

TRACE_SECONDS = 6.0  # the traced part of a --trace 1 window
DECODE_RANGE = "perfbench.paged_decode"
STATS = ("decode_tokens", "decode_steps", "prefill_tokens",
         "prefix_cached_tokens")


@dataclasses.dataclass
class Window:
    """What a run saw; the metric readers read it."""

    seconds: float
    setup_s: float
    model: dict
    completions: list  # in the window: {"latency", "result", "error"}
    # tokens emitted inside the window: the decode steps' by the engine's
    # count (``EngineStats.decode_tokens``), and the prefill's first token
    # of each request the window sent, one for each answer in a closed loop
    # (those waiting for a first token at its open and close differ by few)
    generated: int
    stats: dict  # EngineStats counts' change over the window
    chunks: list  # (pos0, T, last) of prompt chunks in the window
    steps: list  # positions of each decode step's rows in the window
    trace: dict | None = None  # trace.summarize(), with the decode bytes


class _EngineThread:
    """Work done at step boundaries in the engine's own thread: the
    profiler is started and stopped there so that it records that
    thread's operators."""

    def __init__(self):
        self.want = None
        self.prof = None
        self.tracing = False
        self.t_start = self.t_stop = None
        self.done = threading.Event()
        self.decode_bytes = 0
        self.decode_calls = 0
        self.engine = None

    def wrap(self, servicer):
        orig = servicer.step

        def step():
            want, self.want = self.want, None
            if want == "init":  # the profiler's first start is slow
                with torch.profiler.profile(activities=_activities()):
                    pass
                self.done.set()
            elif want == "start":
                self.prof = torch.profiler.profile(activities=_activities())
                self.prof.__enter__()
                self.t_start = time.perf_counter()
                self.tracing = True
            elif want == "stop" and self.tracing:
                self.tracing = False
                self.t_stop = time.perf_counter()
                self.prof.__exit__(None, None, None)
                self.done.set()
            return orig()

        servicer.step = step


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _mark_decode(ctl: _EngineThread, rec: Recorder):
    """Wrap the program's paged decode attention in a range while tracing
    and count the bytes each call needs; returns the undo."""
    from repro_torch.kernels.decode_attention import ops

    orig = ops.paged_decode_attention

    def marked(q, k_store, v_store, block_tables, kv_length):
        if not ctl.tracing:
            return orig(q, k_store, v_store, block_tables, kv_length)
        with torch.profiler.record_function(DECODE_RANGE):
            out = orig(q, k_store, v_store, block_tables, kv_length)
        B, _, Hq, D = q.shape
        ctl.decode_bytes += yardstick.paged_decode_bytes(
            B, Hq, k_store.shape[2], D, q.element_size(),
            block_tables.numel(), rec.step_attended)
        ctl.decode_calls += 1
        return out

    ops.paged_decode_attention = marked
    return lambda: setattr(ops, "paged_decode_attention", orig)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _request(rs, payload, on_done):
    t = time.perf_counter()
    fut = rs.request(payload)
    fut.add_done_callback(lambda f: on_done(f, t))


def _outcome(fut):
    try:
        return fut.result(0), None
    except Exception as e:  # noqa: BLE001 - a failed request is counted
        return None, e


def _warm(rs, rounds):
    for rnd in rounds:
        futs = [rs.request(p) for p in rnd]
        for f in futs:
            f.result(600)


def _stop_service(rh, timeout=300.0):
    rh.close()
    deadline = time.perf_counter() + timeout
    for th in threading.enumerate():
        if th.name.startswith("service-"):
            th.join(max(0.0, deadline - time.perf_counter()))


def run_cell(root, name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start=None, check_sample=None,
             control=False) -> dict:
    """One run; returns the result's fields, the reference's ``verdict``
    and ``check``, each number compared beside its limit.  ``control``
    also runs the lower-precision control on the same sample
    (``control.py``; a benchmark run never does)."""
    t_start = time.perf_counter() if t_start is None else t_start
    from repro_torch.core.middleware import Rhapsody
    from repro_torch.core.service import ServiceDescription
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.client import llm_service_factory

    cell = specs.cell(root, name)
    conf, mix = cell["config"], cell["traffic"]
    m, eng_kw = conf["model"], conf["engine"]
    cfg = ModelConfig(**m)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = weights.port_params(m, seed, dev)
    _sync(dev)

    rec, ctl = Recorder(), _EngineThread()
    make = llm_service_factory(cfg, params, device=dev, seed=seed, paged=True,
                               **eng_kw)

    def factory():
        servicer = make()
        rec.install(servicer.engine)
        ctl.wrap(servicer)
        ctl.engine = servicer.engine
        return servicer

    undo = _mark_decode(ctl, rec) if trace else (lambda: None)
    rh = Rhapsody(n_workers=1)
    try:
        rs = rh.add_service(ServiceDescription(name="llm", factory=factory,
                                               ready_timeout=600.0))
        buckets = check.chunk_buckets(eng_kw)
        # an MoE reference pads each chunk as the engine does
        if m.get("n_experts") and tuple(ctl.engine._chunk_buckets) != buckets:
            raise RuntimeError(f"engine chunks {ctl.engine._chunk_buckets} "
                               f"!= {buckets} worked out from the config")
        decode_bs = sorted({pow2(n) for n in range(1, mix["clients"] + 1)})
        _warm(rs, traffic.warmup_requests(mix, seed, m["vocab"], buckets,
                                          decode_bs))
        if trace:
            ctl.want = "init"
            rs.request({"prompt": [1, 2, 3], "max_new_tokens": 2}).result(600)
            ctl.done.wait(600)
            ctl.done.clear()
        _sync(dev)

        # the closed loop
        rec.reset()
        done_q: queue.SimpleQueue = queue.SimpleQueue()
        streams = traffic.clients(mix, seed, m["vocab"])

        def send(c, reply=None):
            _request(rs, streams[c].next(reply),
                     lambda f, t, c=c: done_q.put((c, f, t,
                                                   time.perf_counter())))

        for c in range(len(streams)):
            send(c)
        t_ramp = time.perf_counter() + mix["ramp_seconds"]
        t0 = t1 = None
        snap0 = snap1 = None
        completions = []
        while True:
            now = time.perf_counter()
            if t0 is None and now >= t_ramp:
                t0 = now
                snap0 = {k: getattr(ctl.engine.stats, k) for k in STATS}
                if trace:
                    ctl.want = "start"
            if t0 is not None and now >= t0 + seconds:
                t1 = now
                snap1 = {k: getattr(ctl.engine.stats, k) for k in STATS}
                break
            if (trace and t0 is not None and ctl.tracing
                    and now >= ctl.t_start + min(seconds, TRACE_SECONDS)):
                ctl.want = "stop"
            until = t_ramp if t0 is None else t0 + seconds
            try:
                c, fut, t_sub, t_done = done_q.get(
                    timeout=max(1e-3, min(until - now, 0.05)))
            except queue.Empty:
                continue
            res, err = _outcome(fut)
            if t0 is not None:
                completions.append({"latency": t_done - t_sub, "result": res,
                                    "error": err, "t_done": t_done})
            send(c, res["tokens"] if res is not None else None)
        if trace and not ctl.done.is_set():
            ctl.want = "stop"
            ctl.done.wait(120)
        _stop_service(rh)
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    setup_s = t0 - t_start
    chunks, steps = rec.window(t0, t1)
    w = Window(seconds=t1 - t0, setup_s=setup_s, model=m,
               completions=completions,
               generated=(snap1["decode_tokens"] - snap0["decode_tokens"]
                          + len(completions)),
               stats={k: snap1[k] - snap0[k] for k in STATS},
               chunks=chunks, steps=steps)
    if trace and ctl.prof is not None:
        w.trace = tracing.summarize(ctl.prof, ctl.t_stop - ctl.t_start,
                                    ranges=(DECODE_RANGE,))
        w.trace["decode_bytes"] = ctl.decode_bytes
        w.trace["decode_calls"] = ctl.decode_calls
    # the program's state goes before the reference runs
    by_list = {id(r.output): r for r in rec.requests.values()}
    finished = [by_list[id(c["result"]["tokens"])] for c in completions
                if c["result"] is not None
                and id(c["result"]["tokens"]) in by_list]
    ctl.engine = ctl.prof = None
    del params, rh, rs, make, factory
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    group = cell["per_layer"] if trace else cell["end_to_end"]
    for spec_m in group:
        v = specs.reader(cell["metrics_dir"], spec_m["name"])(w)
        if v is not None:
            metrics[spec_m["name"]] = {"value": float(v),
                                       "unit": spec_m["unit"]}
    n_sample = check_sample or conf["check"]["sample"]
    verdict = check.judge(m, eng_kw, seed, rec, finished, n_sample, dev,
                          control=control)
    limits = conf["check"]["limits"]
    compared, correct = compare(verdict, limits)
    errors = sum(1 for c in completions if c["error"] is not None)
    out = {
        "correct": correct,
        "attempted": len(completions),
        "failed": errors,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
        "verdict": verdict,
        "check": compared,
    }
    if control:  # the control in the program's place, judged alike
        out["program"] = {"correct": correct, "check": compared}
        out["check"], out["correct"] = compare(verdict["control"], limits)
    if w.trace is not None:
        out["device"]["busy_s"] = w.trace["busy_s"]
        out["device"]["window_s"] = w.trace["window_s"]
        out["breakdown"] = {"device_ops": w.trace["device_ops"],
                            "idle_gaps": w.trace["idle_gaps"]}
    return out


def compare(reading: dict, limits: dict):
    """Each number of ``reading`` beside its limit, and whether every
    one is within it (and some token was compared)."""
    compared = {k: {"value": reading.get(k, math.inf), "limit": v}
                for k, v in limits.items()}
    compared["tokens_compared"] = {"value": reading.get("tokens", 0),
                                   "limit": 1}
    correct = ("error" not in reading and reading.get("tokens", 0) > 0
               and all(compared[k]["value"] <= v for k, v in limits.items()))
    return compared, bool(correct)


def percentile(values, q):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) \
        if len(values) else None
