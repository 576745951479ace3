#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device: the card's name and power limit (``nvidia-smi``); TF32 off.
1. build: compile both hand-written kernels at once (one ``nvcc`` each):
   the paged flash-decode (``kernels/decode_attention/csrc``) and the
   causal flash attention (``kernels/flash_attention/csrc``); ptxas
   registers and spills of each.
2. kernel vs plain: the paged decode kernel against ``ref.paged_decode_ref``
   on the card (rhapsody-demo f32, llama3.2-3b's heads in f32 and bf16;
   ragged lengths, permuted tables, null-block padding rows; f32 within
   2e-5, bf16 within 4e-3 + 2^-7 x |plain|; physical relocation exact),
   then its time beside the plain version's, the library yardstick's
   (``scaled_dot_product_attention``, never called by the port) and the
   least time the card could take (its bound).
3. model: rhapsody-demo (full config, f32): the paged engine's greedy
   transcripts equal the contiguous prefill + decode_step oracle's.
4. launcher: ``repro_torch.launch.serve`` with its defaults (rhapsody-demo,
   2 replicas, 16 requests).
5. serving main path at full width: llama3.2-3b (bf16, 28 layers, random
   weights from a seed) behind ``Rhapsody`` with 2 replicas, 16 requests
   of 32 new tokens, served twice (cold, then warm).
6. flash kernel vs plain: out and lse against ``ref.attention_fwd_ref``
   (rhapsody-demo heads in f32, llama3.2-3b heads in f32 and bf16; B 2,
   S in {1, 63, 64, 65, 200, 1024}; the same limits as phase 2), and the
   gradient of ``FlashAttention`` against autograd of the plain version in
   float32 (1e-4 for f32 inputs, 2e-2 for bf16).
7. flash at the llama3.2-3b training shape (B 2, S 2048, Hq 24, Hkv 8,
   D 128, bf16): the wrapper's out, lse and gradient against the plain
   version as in phase 6, then the times of the kernel, the plain
   version, the library yardstick (SDPA, causal, GQA), ``attention_bwd``
   and the bound.
8. train step: rhapsody-demo (full config, f32): one step on the card
   equals the same step on the CPU (loss within 1e-5 relative, every
   parameter within atol 2e-5, rtol 2e-3; Adam eps 1e-3, so the first
   update is not the sign of gradients below eps); then 30 steps on the
   synthetic corpus on the card, after which the loss on a batch the steps
   did not see has fallen.
9. trainer launcher: ``repro_torch.launch.train --steps 20``.
10. training main path at full width: llama3.2-3b (bf16, 28 layers, remat
    full, random weights from seed 0) through ``DataPipeline``,
    ``init_state`` and ``make_train_step``: global batch 2, seq 2048,
    AdamW, 3 steps.

Every main-path phase sets both kernels' launch counts to 0 just before it
runs and checks them just after: a serving phase launches the decode
kernel n_layers x decode batches times and the flash kernel never; a
training phase launches the flash kernel 2 x n_layers x steps times (remat
runs each block's forward again in the backward) and the decode kernel
never.  Any failure exits non-zero.  The last lines are the kernels' JSON
record, the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
Without a CUDA card it exits 2 and prints no result.
"""
import concurrent.futures
import gc
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
# the training main path (phase 10)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
# gradients of the flash kernel's Function vs autograd of the plain version
# in float32: 1e-4 for f32 inputs; 2e-2 for bf16 (the reference's own bf16
# limit for this kernel, tests/test_kernels.py)
F32_GRAD_TOL, BF16_GRAD_TOL = 1e-4, 2e-2


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


def phase_model(torch, configs, get_model, engine_mod, ops, fa):
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
    ops.launches = fa.launches = 0
    uids = [eng.submit(p, max_new_tokens=steps) for p in prompts]
    done = eng.run()
    torch.cuda.synchronize()
    launches = ops.launches
    check(fa.launches == 0, "serving launched the flash kernel")
    got = [done[u].output for u in uids]
    check(got == oracle, f"paged transcripts {got} != oracle {oracle}")
    check(launches == cfg.n_layers * eng.stats.decode_steps > 0,
          f"launches {launches} != {cfg.n_layers} x "
          f"{eng.stats.decode_steps} decode steps")
    return {"prompts": len(prompts), "new_tokens": steps,
            "transcripts_equal": True, "launches": launches,
            "decode_steps": eng.stats.decode_steps}


def phase_launcher(ops, fa, serve):
    """The launcher with its defaults: rhapsody-demo, 2 replicas."""
    ops.launches = fa.launches = 0
    t0 = time.perf_counter()
    out = serve.main([] if DEVICE == "cuda" else ["--device", DEVICE])
    launches = ops.launches
    check(fa.launches == 0, "launcher: serving launched the flash kernel")
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


def phase_main_path(torch, configs, core, client, ops, fa):
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
        ops.launches = fa.launches = 0
        prompts, cold = serve_pass()
        _, warm = serve_pass()
        launches = ops.launches
        check(fa.launches == 0, "main path: serving launched the flash "
                                "kernel")
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


def flash_inputs(torch, seed, B, S, Hq, Hkv, D, dtype):
    """q [B,S,Hq,D], k/v [B,S,Hkv,D] on the card from a seed."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn((B, S, H, D), generator=gen, device=DEVICE)
                 .to(dtype) for H in (Hq, Hkv, Hkv))


def flash_case(torch, fa, fa_ref, name, dtype, B, S, Hq, Hkv, D, tol, gtol):
    """The wrapper on the card against the plain version on the same
    inputs: out from ``FlashAttention.apply``, lse from ``fa._launch``, and
    the gradient of ``FlashAttention`` against autograd of the plain
    version in float32.  Returns the case's record and (q, k, v, out,
    lse)."""
    atol, rtol = tol
    q, k, v = flash_inputs(torch, S, B, S, Hq, Hkv, D, dtype)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.FlashAttention.apply(qg, kg, vg)
    _, lse = fa._launch(q, k, v)
    plain, plain_lse = fa_ref.attention_fwd_ref(q, k, v)
    torch.cuda.synchronize()
    diff = (out.detach().float() - plain.float()).abs()
    err = float(diff.max())
    lse_err = float((lse - plain_lse).abs().max())
    check(bool((diff <= atol + rtol * plain.float().abs()).all()),
          f"flash {name} S={S}: out error {err} > {atol} + {rtol} x |plain|")
    check(lse_err <= 2e-5 + 2e-5 * float(plain_lse.abs().max()),
          f"flash {name} S={S}: lse error {lse_err}")
    gen = torch.Generator(device=DEVICE).manual_seed(S + 1)
    dout = torch.randn(out.shape, generator=gen, device=DEVICE).to(dtype)
    out.backward(dout)
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    fa_ref.attention_fwd_ref(q32, k32, v32)[0].backward(dout.float())
    grad_err = 0.0
    for got, want in ((qg, q32), (kg, k32), (vg, v32)):
        d = (got.grad.float() - want.grad).abs()
        grad_err = max(grad_err, float(d.max()))
        check(bool((d <= gtol + gtol * want.grad.abs()).all()),
              f"flash {name} S={S}: gradient error {float(d.max())} > "
              f"{gtol} + {gtol} x |plain|")
    record = {"config": name, "dtype": str(dtype).split(".")[-1], "B": B,
              "S": S, "Hq": Hq, "Hkv": Hkv, "D": D, "max_err": err,
              "lse_err": lse_err, "grad_err": grad_err, "atol": atol,
              "rtol": rtol, "grad_tol": gtol}
    return record, (q, k, v, out.detach(), lse)


def phase_flash(torch, fa, fa_ref):
    """Flash kernel vs plain on the card: out, lse and the gradient."""
    cases = []
    for name, dtype, Hq, Hkv, D, tol, gtol in (
            ("rhapsody-demo", torch.float32, 8, 4, 32, F32_TOL,
             F32_GRAD_TOL),
            ("llama3.2-3b-f32", torch.float32, 24, 8, 128, F32_TOL,
             F32_GRAD_TOL),
            ("llama3.2-3b", torch.bfloat16, 24, 8, 128, BF16_TOL,
             BF16_GRAD_TOL)):
        for S in (1, 63, 64, 65, 200, 1024):
            cases.append(flash_case(torch, fa, fa_ref, name, dtype, 2, S,
                                    Hq, Hkv, D, tol, gtol)[0])
    return cases, max(c["max_err"] for c in cases)


def phase_flash_timing(torch, fa_kernel, fa, fa_ref):
    """The flash kernel at the llama3.2-3b training shape: the wrapper and
    its gradient held against the plain version there, then the raw
    kernel's time beside the plain version's, the library yardstick's,
    the plain backward's and the bound."""
    B, S, Hq, Hkv, D = TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128
    case, (q, k, v, out, lse) = flash_case(
        torch, fa, fa_ref, "llama3.2-3b", torch.bfloat16, B, S, Hq, Hkv, D,
        BF16_TOL, BF16_GRAD_TOL)
    gc.collect()
    torch.cuda.empty_cache()
    scale = 1.0 / math.sqrt(D)
    out_t, lse_t = torch.empty_like(out), torch.empty_like(lse)

    def run_kernel():
        err = fa_kernel.flash_attention_fwd(q, k, v, out_t, lse_t, scale)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def run_library():
        sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)

    dout = torch.randn(out.shape, device=DEVICE).to(out.dtype)
    kernel_ms = cuda_ms(run_kernel, 20)
    plain_ms = cuda_ms(lambda: fa_ref.attention_fwd_ref(q, k, v), 3)
    library_ms = cuda_ms(run_library, 20)
    bwd_ms = cuda_ms(lambda: fa_ref.attention_bwd(q, k, v, out, lse, dout),
                     3)
    kernel_ms_2 = cuda_ms(run_kernel, 20)
    itemsize = 2
    bytes_moved = ((2 * B * S * Hq * D + 2 * B * S * Hkv * D) * itemsize
                   + B * Hq * S * 4)  # q, k, v, out; lse
    flops = 4 * B * Hq * D * S * (S + 1) // 2  # causal q.k and p.v
    byte_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    op_ms = flops / H100_BF16_FLOPS * 1e3
    return {"config": "llama3.2-3b", "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
            "D": D, "dtype": "bfloat16", "kernel_ms": kernel_ms,
            "kernel_ms_repeat": kernel_ms_2, "plain_ms": plain_ms,
            "library_ms": library_ms, "attention_bwd_ms": bwd_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "bytes": bytes_moved, "flops": flops,
            "max_err": case["max_err"], "lse_err": case["lse_err"],
            "grad_err": case["grad_err"],
            "achieved_TFLOPs": flops / (kernel_ms * 1e-3) / 1e12}


def phase_train_step(torch, configs, get_model, fa, ops, optim, train,
                     data):
    """rhapsody-demo full config, f32: one step on the card equals the same
    step on the CPU; then 30 steps on the card, where the loss falls."""
    cfg = configs.get_config("rhapsody-demo")
    api = get_model(cfg)
    # eps 1e-3: Adam's first update g / (|g| + eps) is then linear in the
    # gradients below eps; with eps 1e-8 it is their sign, and float32 sums
    # taken in another order on the card flip it (PERF.md)
    opt = optim.OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                decay_steps=10)
    tcfg = train.TrainConfig(optimizer=opt)
    cpu = train.init_state(torch.Generator().manual_seed(0), api, cfg, opt,
                           device="cpu")
    card = {"params": optim.tree_map(
        lambda t: t.detach().to(DEVICE, copy=True).requires_grad_(),
        cpu["params"])}
    card["opt"] = optim.adamw_init(card["params"], opt)
    batch = data.DataPipeline(data.DataConfig(vocab=cfg.vocab),
                              device="cpu").next_batch()
    step = train.make_train_step(api, cfg, tcfg)
    _, m_cpu = step(cpu, batch)
    ops.launches = fa.launches = 0
    _, m_card = step(card, {k: v.to(DEVICE) for k, v in batch.items()})
    torch.cuda.synchronize()
    one_step = fa.launches
    check(one_step == 2 * cfg.n_layers and ops.launches == 0,
          f"train step: flash launches {one_step} != 2 x {cfg.n_layers}")
    loss_cpu, loss_card = float(m_cpu["loss"]), float(m_card["loss"])
    check(abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu),
          f"train step: loss {loss_card} on the card != {loss_cpu} on the "
          f"CPU")
    worst = 0.0
    for a, b in zip(optim.tree_leaves(card["params"]),
                    optim.tree_leaves(cpu["params"])):
        d = (a.detach().cpu() - b.detach()).abs()
        worst = max(worst, float(d.max()))
        check(bool((d <= 2e-5 + 2e-3 * b.detach().abs()).all()),
              f"train step: parameter error {float(d.max())}")

    # 30 steps on the synthetic corpus; the loss on a batch the steps do
    # not see (the corpus at cursor 500) falls
    tcfg = train.TrainConfig(optimizer=optim.OptimizerConfig(
        lr=3e-3, warmup_steps=2, decay_steps=100))
    pipe = data.DataPipeline(data.DataConfig(vocab=cfg.vocab),
                             device=DEVICE)
    unseen = data.DataPipeline(data.DataConfig(vocab=cfg.vocab),
                               device=DEVICE)
    unseen.restore({"step": 500, "seed": 0})
    held = unseen.next_batch()
    state = train.init_state(torch.Generator(device=DEVICE).manual_seed(0),
                             api, cfg, tcfg.optimizer, device=DEVICE)
    with torch.no_grad():
        held_before = float(api.loss(state["params"], held, cfg)[0])
    ops.launches = fa.launches = 0
    t0 = time.perf_counter()
    state, hist = train.train_loop(api, cfg, tcfg, steps=30,
                                   data_iter=iter(pipe), state=state,
                                   log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launches
    losses = [h["loss"] for h in hist]
    check(launches == 2 * cfg.n_layers * 30 and ops.launches == 0,
          f"30 steps: flash launches {launches} != 2 x {cfg.n_layers} x 30")
    with torch.no_grad():
        held_after = float(api.loss(state["params"], held, cfg)[0])
    check(all(math.isfinite(x) for x in losses)
          and held_after < held_before,
          f"30 steps: held-out loss {held_before} -> {held_after}; "
          f"losses {losses}")
    return {"config": cfg.name, "dtype": cfg.compute_dtype,
            "step_loss_cpu": loss_cpu, "step_loss_card": loss_card,
            "step_max_param_err": worst, "step_launches": one_step,
            "losses": losses, "held_loss_before": held_before,
            "held_loss_after": held_after, "launches": launches,
            "seconds": seconds}


def phase_train_launcher(fa, ops, launch_train):
    """The trainer launcher with its defaults except --steps 20."""
    ops.launches = fa.launches = 0
    out = launch_train.main(["--steps", "20"]
                            + ([] if DEVICE == "cuda" else
                               ["--device", DEVICE]))
    launches = fa.launches
    losses = out["losses"]
    check(len(losses) == 20 and all(math.isfinite(x) for x in losses),
          f"trainer launcher: losses {losses}")
    check(launches == 2 * 4 * 20 and ops.launches == 0,
          f"trainer launcher: flash launches {launches} != 2 x 4 x 20")
    return {"losses": losses, "launches": launches,
            "seconds": out["seconds"], "device": out["device"]}


def train_main_path():
    """The training main path (phase 10; profile_train.py builds it here
    too): llama3.2-3b, AdamW, the synthetic corpus at global batch 2 x seq
    2048 on the card, the state from seed 0 -> (cfg, api, tcfg, pipe,
    state, step)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.substrate import data
    from repro_torch.training import optim, train

    cfg = configs.get_config(MAIN_PATH_ARCH)
    api = get_model(cfg)
    tcfg = train.TrainConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        optimizer=optim.OptimizerConfig(lr=3e-4, warmup_steps=1,
                                        decay_steps=100))
    pipe = data.DataPipeline(data.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH),
        device=DEVICE)
    state = train.init_state(torch.Generator(device=DEVICE).manual_seed(0),
                             api, cfg, tcfg.optimizer, device=DEVICE)
    return cfg, api, tcfg, pipe, state, train.make_train_step(api, cfg, tcfg)


def phase_train_main_path(torch, fa, ops, optim):
    """llama3.2-3b at full width: DataPipeline -> init_state ->
    make_train_step, global batch 2, seq 2048, 3 AdamW steps."""
    t_up = time.perf_counter()
    cfg, _, _, pipe, state, step = train_main_path()
    n_params = sum(p.numel() for p in optim.tree_leaves(state["params"]))
    watch = [state["params"]["blocks"][0]["attn"]["q"]["w"],
             state["params"]["blocks"][-1]["mlp"]["down"]["w"],
             state["params"]["unembed"]["w"]]
    before = [w.detach()[:64].clone() for w in watch]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_up
    torch.cuda.reset_peak_memory_stats()
    ops.launches = fa.launches = 0
    times, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        batch = pipe.next_batch()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = fa.launches
    check(launches == 2 * cfg.n_layers * TRAIN_STEPS and ops.launches == 0,
          f"training main path: flash launches {launches} != 2 x "
          f"{cfg.n_layers} x {TRAIN_STEPS}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"training main path: loss {losses} / grad norm {norms}")
    check(1.0 < losses[0] < 3 * math.log(cfg.vocab),
          f"training main path: first loss {losses[0]} is not near "
          f"ln(vocab) = {math.log(cfg.vocab)}")
    changed = [bool((w.detach()[:64] != b).any())
               for w, b in zip(watch, before)]
    check(all(changed), f"training main path: parameters unchanged "
                        f"{changed}")
    median = sorted(times)[len(times) // 2]
    return {"config": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "dtype": cfg.compute_dtype, "remat": cfg.remat,
            "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "setup_seconds": setup_s, "step_seconds": times,
            "step_median_s": median,
            "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / median,
            "losses": losses, "grad_norms": norms, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from repro_torch import configs, core
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model
    from repro_torch.serving import client, engine
    from repro_torch.substrate import data
    from repro_torch.training import optim, train

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

    # 1. build both kernels at once, one nvcc each
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(kernel.load), pool.submit(fa_kernel.load)]:
            fut.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {
              "library": os.path.relpath(log["path"], ROOT),
              "seconds": log["seconds"],
              "ptxas": [ln.strip() for ln in log["ptxas"].splitlines()
                        if "registers" in ln or "spill" in ln]}
              for name, log in build.build_log.items()}})

    # 2. paged decode kernel vs plain
    cases, timing, worst = phase_kernel(torch, ops, ref, kernel)
    emit({"phase": "kernel", "cases": cases, "timing": timing})

    # 3. model on the card, f32
    emit({"phase": "model", **phase_model(torch, configs, get_model, engine,
                                          ops, fa)})

    # 4. the launcher end to end
    emit({"phase": "launcher", **phase_launcher(ops, fa, serve)})

    # 5. the serving main path at a real model's full width
    main_path = phase_main_path(torch, configs, core, client, ops, fa)
    emit({"phase": "main_path", **main_path})
    gc.collect()
    torch.cuda.empty_cache()

    # 6. flash kernel vs plain, with the gradient
    flash_cases, flash_worst = phase_flash(torch, fa, fa_ref)
    emit({"phase": "flash", "cases": flash_cases})

    # 7. flash timing at the training shape
    flash_timing = phase_flash_timing(torch, fa_kernel, fa, fa_ref)
    emit({"phase": "flash_timing", **flash_timing})
    gc.collect()
    torch.cuda.empty_cache()

    # 8. one train step on the card vs the CPU; 30 steps on the card
    emit({"phase": "train_step", **phase_train_step(
        torch, configs, get_model, fa, ops, optim, train, data)})

    # 9. the trainer launcher
    emit({"phase": "train_launcher", **phase_train_launcher(
        fa, ops, launch_train)})
    gc.collect()
    torch.cuda.empty_cache()

    # 10. the training main path at a real model's full width
    train_path = phase_train_main_path(torch, fa, ops, optim)
    emit({"phase": "train_main_path", **train_path})

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
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:70",
        "launches": train_path["launches"],
        "max_abs_err": max(flash_worst, flash_timing["max_err"]),
        "ms": flash_timing["kernel_ms"],
        "plain_ms": flash_timing["plain_ms"],
        "bound_ms": flash_timing["bound_ms"],
        "bound_by": flash_timing["bound_by"],
        "library_ms": flash_timing["library_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
