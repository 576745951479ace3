#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernel to account.

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device: the card's name and power limit (``nvidia-smi``); TF32 off.
1. build: compile the hand-written paged flash-decode kernel from
   ``src/repro_torch/kernels/decode_attention/csrc``.
2. kernel vs plain: the kernel against ``ref.paged_decode_ref`` on the card
   (rhapsody-demo f32, llama3.2-3b's heads in f32 and bf16; ragged lengths,
   permuted tables, null-block padding rows; f32 within 2e-5, bf16 within
   4e-3 + 2^-7 x |plain|; physical relocation exact), then its time beside
   the plain version's, the library yardstick's
   (``scaled_dot_product_attention``, never called by the port) and the
   least time the card could take (its bound).
3. model: rhapsody-demo (full config, f32): the paged engine's greedy
   transcripts equal the contiguous prefill + decode_step oracle's.
4. launcher: ``repro_torch.launch.serve`` with its defaults (rhapsody-demo,
   2 replicas, 16 requests).
5. main path at full width: llama3.2-3b (bf16, 28 layers, random weights
   from a seed) behind ``Rhapsody`` with 2 replicas, 16 requests of 32 new
   tokens, served twice (cold, then warm).

Every main-path phase sets the kernel's launch count to 0 just before it
runs and checks it just after: the count must equal n_layers x the decode
batches.  Any failure exits non-zero.  The last lines are the kernels'
JSON record, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits 2 and
prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
DEVICE = "cuda"
# kernel vs plain, (atol, rtol): f32 differs only in summation order; bf16
# outputs are rounded to bf16 on both sides, so allow 4e-3 plus one bf16
# ulp (2^-7) of the value
F32_TOL = (2e-5, 2e-5)
BF16_TOL = (4e-3, 2.0 ** -7)

# the main path's model and engine (phase 5; profile_engine.py uses them too)
MAIN_PATH_ARCH = "llama3.2-3b"
MAIN_PATH_NEW_TOKENS = 32
MAIN_PATH_ENGINE = dict(max_num_seqs=8, max_num_batched_tokens=512,
                        max_len=1024, prefill_buckets=(16, 32, 64),
                        block_size=16)


def main_path_prompt_lens(rng, n):
    """Log-normal prompt lengths (median ~20 tokens) that fit max_len."""
    hi = MAIN_PATH_ENGINE["max_len"] - MAIN_PATH_NEW_TOKENS - 1
    return np.clip(np.exp(rng.normal(3.0, 0.7, n)), 4, hi).astype(int)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps, warmup=2):
    """Device time per call of ``fn`` (CUDA events around ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paged_inputs(torch, rng, *, L, B, Hkv, G, D, bs, mb, num_blocks, lens,
                 dtype, pad_rows=0):
    """Layer stores [L, N, bs, Hkv, D], q [B, 1, Hq, D], permuted tables of
    distinct blocks, and ``pad_rows`` engine-style padding rows (length 1,
    all-null tables)."""
    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(int(rng.randint(1 << 30)))
    shape = (L, num_blocks, bs, Hkv, D)
    ks = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vs = torch.randn(shape, generator=gen, device=dev).to(dtype)
    n = B + pad_rows
    q = torch.randn((n, 1, Hkv * G, D), generator=gen, device=dev).to(dtype)
    bt = np.zeros((n, mb), np.int32)
    perm = rng.permutation(np.arange(1, num_blocks))
    lens = np.asarray(list(lens) + [1] * pad_rows, np.int32)
    used = 0
    for b in range(B):
        k = -(-int(lens[b]) // bs)
        bt[b, :k] = perm[used:used + k]
        used += k
    return (ks, vs, q, torch.from_numpy(bt).to(dev),
            torch.from_numpy(lens).to(dev))


def phase_kernel(torch, ops, ref, kernel):
    """Kernel vs plain on the card; times at the llama3.2-3b decode shape."""
    rng = np.random.RandomState(0)
    bs = 16
    cases = []
    worst = {}
    for name, dtype, Hkv, G, D, (atol, rtol) in (
            ("rhapsody-demo", torch.float32, 4, 2, 32, F32_TOL),
            ("llama3.2-3b-f32", torch.float32, 8, 3, 128, F32_TOL),
            ("llama3.2-3b", torch.bfloat16, 8, 3, 128, BF16_TOL)):
        mb = 16
        lens = [1, bs - 1, bs, bs + 1, mb * bs, 37, 100, 200]
        ks, vs, q, bt, ln = paged_inputs(
            torch, rng, L=1, B=len(lens), Hkv=Hkv, G=G, D=D, bs=bs, mb=mb,
            num_blocks=160, lens=lens, dtype=dtype, pad_rows=2)
        out = ops.paged_decode_attention(q, ks[0], vs[0], bt, ln)
        n = q.shape[0]
        plain = ref.paged_decode_ref(q.reshape(n, Hkv, G, D), ks[0], vs[0],
                                     bt, ln).reshape(out.shape)
        torch.cuda.synchronize()
        diff = (out.float() - plain.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * plain.float().abs()).all())
        check(ok, f"{name}: kernel vs plain max error {err} > "
                  f"{atol} + {rtol} x |plain|")
        # relocate physical blocks: output must not change at all
        perm = torch.from_numpy(np.concatenate(
            [[0], 1 + rng.permutation(ks.shape[1] - 1)])).to(DEVICE)
        inv = torch.argsort(perm)
        out2 = ops.paged_decode_attention(
            q, ks[0][inv].contiguous(), vs[0][inv].contiguous(),
            perm[bt.long()].to(torch.int32), ln)
        check(torch.equal(out, out2), f"{name}: relocation changed output")
        worst[name] = err
        cases.append({"config": name, "dtype": str(dtype).split(".")[-1],
                      "Hkv": Hkv, "G": G, "D": D, "block_size": bs,
                      "lens": lens, "pad_rows": 2, "max_err": err,
                      "atol": atol, "rtol": rtol, "relocation_exact": True})

    # timing at the llama3.2-3b main-path decode shape: 28 layer stores as
    # the engine holds them (1.9 GB, so each call finds its layer cold in
    # the 50 MB L2), batch 8, lengths around 512, max_len 1024
    L, B, Hkv, G, D, mb, N = 28, 8, 8, 3, 128, 64, 513
    lens = [int(x) for x in rng.randint(480, 545, size=B)]
    ks, vs, q, bt, ln = paged_inputs(
        torch, rng, L=L, B=B, Hkv=Hkv, G=G, D=D, bs=bs, mb=mb, num_blocks=N,
        lens=lens, dtype=torch.bfloat16)
    out = torch.empty((B, Hkv, G, D), dtype=q.dtype, device=DEVICE)
    qg = q.reshape(B, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    main_err = 0.0
    for layer in (0, L - 1):
        got = ops.paged_decode_attention(q, ks[layer], vs[layer], bt, ln)
        plain = ref.paged_decode_ref(qg, ks[layer], vs[layer], bt,
                                     ln).float()
        diff = (got.reshape(plain.shape).float() - plain).abs()
        atol, rtol = BF16_TOL
        check(bool((diff <= atol + rtol * plain.abs()).all()),
              f"llama3.2-3b main shape: kernel vs plain error "
              f"{float(diff.max())}")
        main_err = max(main_err, float(diff.max()))
    worst["llama3.2-3b"] = max(worst["llama3.2-3b"], main_err)

    def run_kernel():
        for layer in range(L):
            err = kernel.paged_decode_attention_grouped(
                qg, ks[layer], vs[layer], bt, ln, out, scale)
            if err:
                raise RuntimeError(f"CUDA error {err}")

    def run_plain():
        for layer in range(L):
            ref.paged_decode_ref(qg, ks[layer], vs[layer], bt, ln)

    S = mb * bs
    mask = (torch.arange(S, device=DEVICE)[None, :] < ln[:, None].long()
            )[:, None, None, :]  # [B, 1, 1, S]
    kc = [ref.gather_kv(ks[layer], bt).transpose(1, 2).contiguous()
          for layer in range(L)]  # [B, Hkv, S, D]
    vc = [ref.gather_kv(vs[layer], bt).transpose(1, 2).contiguous()
          for layer in range(L)]
    qs = q.transpose(1, 2).contiguous()  # [B, Hq, 1, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def run_library():
        for layer in range(L):
            sdpa(qs, kc[layer], vc[layer], attn_mask=mask, enable_gqa=True)

    kernel_ms = cuda_ms(run_kernel, 20) / L
    plain_ms = cuda_ms(run_plain, 3) / L
    library_ms = cuda_ms(run_library, 5) / L
    kernel_ms_2 = cuda_ms(run_kernel, 20) / L
    itemsize = 2
    tot = sum(lens)
    bytes_moved = (tot * Hkv * D * 2 * itemsize  # K and V rows attended
                   + 2 * B * Hkv * G * D * itemsize  # q in, out
                   + bt.numel() * 4 + B * 4)  # tables, lengths
    flops = 4 * tot * Hkv * G * D  # q.k and p.v, multiply-add each
    byte_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    op_ms = flops / H100_BF16_FLOPS * 1e3
    timing = {"config": "llama3.2-3b", "layers": L, "B": B, "lens": lens,
              "block_size": bs, "max_blocks": mb, "num_blocks": N,
              "kernel_ms": kernel_ms, "kernel_ms_repeat": kernel_ms_2,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": max(byte_ms, op_ms),
              "bound_by": "bytes" if byte_ms >= op_ms else "operations",
              "bytes": bytes_moved, "flops": flops, "max_err": main_err,
              "achieved_GBps": bytes_moved / (kernel_ms * 1e-3) / 1e9}
    del ks, vs, kc, vc
    torch.cuda.empty_cache()
    return cases, timing, worst


def phase_model(torch, configs, get_model, engine_mod, ops):
    """rhapsody-demo full config, f32: paged engine == contiguous oracle."""
    cfg = configs.get_config("rhapsody-demo")
    api = get_model(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = api.init(gen, cfg, device=DEVICE)
    rng = np.random.RandomState(1)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (3, 8, 9, 17, 30)]
    steps = 6
    oracle = []
    for p in prompts:
        cache, logits = api.prefill(
            params, {"tokens": torch.tensor([p], device=DEVICE)}, cfg,
            max_len=128)
        out = [int(logits[0].argmax())]
        for _ in range(steps - 1):
            cache, logits = api.decode(
                params, cache, torch.tensor([out[-1]], device=DEVICE), cfg)
            out.append(int(logits[0].argmax()))
        oracle.append(out)
    eng = engine_mod.InferenceEngine(
        cfg, params, device=DEVICE, max_num_seqs=4,
        max_num_batched_tokens=256, max_len=128, prefill_buckets=(16, 32),
        block_size=16)
    ops.launches = 0
    uids = [eng.submit(p, max_new_tokens=steps) for p in prompts]
    done = eng.run()
    torch.cuda.synchronize()
    launches = ops.launches
    got = [done[u].output for u in uids]
    check(got == oracle, f"paged transcripts {got} != oracle {oracle}")
    check(launches == cfg.n_layers * eng.stats.decode_steps > 0,
          f"launches {launches} != {cfg.n_layers} x "
          f"{eng.stats.decode_steps} decode steps")
    return {"prompts": len(prompts), "new_tokens": steps,
            "transcripts_equal": True, "launches": launches,
            "decode_steps": eng.stats.decode_steps}


def phase_launcher(ops, serve):
    """The launcher with its defaults: rhapsody-demo, 2 replicas."""
    ops.launches = 0
    t0 = time.perf_counter()
    out = serve.main([] if DEVICE == "cuda" else ["--device", DEVICE])
    launches = ops.launches
    res = out["results"]
    check(len(res) == 16 and all(len(r["tokens"]) == 8 for r in res),
          "launcher: a request came back short")
    check(all(e is None for e in out["errors"]),
          f"launcher: replica errors {out['errors']}")
    check(launches == 4 * out["decode_steps"] > 0,
          f"launcher: launches {launches} != 4 x {out['decode_steps']}")
    return {"requests": len(res), "launches": launches,
            "decode_steps": out["decode_steps"],
            "seconds": time.perf_counter() - t0}


def phase_main_path(torch, configs, core, client, ops):
    """llama3.2-3b at full width behind Rhapsody: 2 replicas, 16 requests,
    served twice with fresh prompts of the same lengths.  The first pass
    pays every first call (matmul shapes, allocator growth); the second
    is warm."""
    cfg = configs.get_config(MAIN_PATH_ARCH)
    replicas, n_req, mnt = 2, 16, MAIN_PATH_NEW_TOKENS
    rh = core.Rhapsody(core.ResourceDescription(nodes=replicas,
                                                cores_per_node=16),
                       n_workers=2)
    try:
        t_up = time.perf_counter()
        rs = rh.add_service(core.ServiceDescription(
            name="llm", replicas=replicas, ready_timeout=600,
            factory=client.llm_service_factory(
                cfg, device=DEVICE, **MAIN_PATH_ENGINE)))
        setup_s = time.perf_counter() - t_up
        rng = np.random.RandomState(0)
        lens = main_path_prompt_lens(rng, n_req)

        def serve_pass():
            prompts = [list(map(int, rng.randint(0, cfg.vocab,
                                                 size=int(n))))
                       for n in lens]
            descs = [core.TaskDescription(
                kind=core.TaskKind.INFERENCE, service="llm",
                payload={"prompt": p, "max_new_tokens": mnt},
                task_type="inference") for p in prompts]
            t0 = time.perf_counter()
            uids = rh.submit(descs)
            check(rh.wait(uids, timeout=600), "main path timed out")
            results = [rh.result(u) for u in uids]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(all(len(r["tokens"]) == mnt for r in results),
                  "main path: a request came back short")
            check(all(0 <= t < cfg.vocab
                      for r in results for t in r["tokens"]),
                  "main path: a token outside the vocabulary")
            lat = sorted(r["latency_s"] for r in results)
            gen_tokens = sum(len(r["tokens"]) for r in results)
            all_tokens = gen_tokens + sum(r["n_prompt"] for r in results)
            return prompts, {
                "seconds": dt, "tok_per_s": all_tokens / dt,
                "gen_tok_per_s": gen_tokens / dt,
                "latency_p50_s": lat[len(lat) // 2],
                "latency_p95_s": lat[int(len(lat) * 0.95)]}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.launches = 0
        prompts, cold = serve_pass()
        _, warm = serve_pass()
        launches = ops.launches
        errors = [inst.error for inst in rs.instances]
        decode_steps = sum(inst.servicer.stats.decode_steps
                           for inst in rs.instances)
        stats = rs.stats()
        check(all(e is None for e in errors), f"replica errors {errors}")
        check(launches == cfg.n_layers * decode_steps > 0,
              f"launches {launches} != {cfg.n_layers} x {decode_steps}")
        # the served weights give finite logits of the expected shape
        eng = rs.instances[0].servicer.engine
        _, logits = eng.api.prefill(
            eng.params, {"tokens": torch.tensor([prompts[0]], device=DEVICE)},
            cfg, max_len=64)
        check(tuple(logits.shape) == (1, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              "main path: prefill logits not finite")
        return {"config": cfg.name, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "vocab": cfg.vocab,
                "dtype": cfg.compute_dtype, "replicas": replicas,
                "requests_per_pass": n_req, "max_new_tokens": mnt,
                "prompt_lens": [int(x) for x in lens],
                "setup_seconds": setup_s, "cold": cold, "warm": warm,
                "launches": launches, "decode_steps": decode_steps,
                "per_replica_requests": [p["requests"]
                                         for p in stats["per_replica"]],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        rh.close()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from repro_torch import configs, core
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.serving import client, engine

    # 0. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 1. build
    t0 = time.perf_counter()
    kernel.load()
    log = build.build_log["paged_decode_attention"]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(log["path"], ROOT),
          "ptxas": [ln.strip() for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 2. kernel vs plain
    cases, timing, worst = phase_kernel(torch, ops, ref, kernel)
    emit({"phase": "kernel", "cases": cases, "timing": timing})

    # 3. model on the card, f32
    emit({"phase": "model", **phase_model(torch, configs, get_model, engine,
                                          ops)})

    # 4. the launcher end to end
    emit({"phase": "launcher", **phase_launcher(ops, serve)})

    # 5. the main path at a real model's full width
    main_path = phase_main_path(torch, configs, core, client, ops)
    emit({"phase": "main_path", **main_path})

    emit({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:147",
        "launches": main_path["launches"],
        "max_abs_err": max(worst.values()),
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
