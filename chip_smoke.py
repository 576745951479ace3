#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device: the card's name and power limit (``nvidia-smi``); TF32 off.
1. build: compile the five hand-written kernels' four sources at once
   (one ``nvcc`` each): the flash-decode pair, paged and contiguous
   (``kernels/decode_attention/csrc``), the causal flash attention
   (``kernels/flash_attention/csrc``), the chunked WKV6
   (``kernels/rwkv6/csrc``) and the chunked Mamba2 SSD
   (``kernels/mamba2/csrc``); ptxas registers and spill bytes of every
   kernel template, and the counts of wgmma (HGMMA), mma.sync (HMMA), TMA
   (UTMALDG, UTMASTG) and mbarrier (SYNCS) instructions in the flash, WKV6
   and SSD libraries' SASS (``cuobjdump -sass``).
2. paged decode kernel vs plain: against ``ref.paged_decode_ref`` on the
   card at every head dim (8, 16, 32, 64, 80, 128; the heads of the
   configs that run each, ``DECODE_HEADS``, internvl2-1b's seven query
   heads a group among them) in f32 and bf16 (ragged
   lengths, permuted tables, null-block padding rows; f32 within 2e-5,
   bf16 within 4e-3 + 2^-7 x |plain|; physical relocation exact); the
   split's edges (one kv head of one sequence, so the kernel splits it
   across the most blocks: lengths at the tile edges and around every
   split boundary, split ranks left empty, lengths past the cache; both
   entry points, two calls bit-equal, relocation exact); then its times
   at the llama3.2-3b decode shape: eager, replayed from a CUDA graph of
   the 28-layer loop (``graph_ms``), the host's time to issue the
   wrapper (``host_ms``), beside the plain version, the library
   yardstick (``scaled_dot_product_attention``, never called by the port;
   eager and from a graph) and the least time the card could take (its
   bound).
3. contiguous decode kernel vs plain: against ``ref.decode_ref`` at every
   head dim of ``DECODE_HEADS``, f32 and bf16, the same limits; S 77 and
   512; ragged lengths and idle rows past S; whisper-small's cross shape
   (``WHISPER_CROSS``: B 8, Hkv 12, G 1, D 64, all 1500 positions); then
   its times, as in phase 2, at zamba2's decode shape (B 8, Hkv 32, D 80,
   S 512, 9 layer caches), at llama3.2-3b's heads, at whisper's cross
   shape (12 layer caches) and at internvl2-1b's heads (B 8, Hkv 2, G 7,
   D 64, S 512, 24 layer caches), beside the plain version, SDPA (GQA,
   length mask) and the bound.
4. WKV6 kernel vs plain: y and the final state against
   ``ref.wkv_chunked_ref`` (``WKV_CASES`` in f32 and bf16: T 37 in chunks
   of 8, 200 and 256; a non-zero initial state; f32 within 1e-4
   relative, the reference's own limit; bf16 y as above); in bf16 also
   ``WKV_BF16_CASES``: T 1, 17, 20 and 24 as one chunk, T = L, 2L and 3L, s0
   absent and set, a decay down to -e^3 a token, head_dim 16, 32 and 64,
   chunks of 8 and 32; two calls bit-equal at the prefill shape; bf16
   shapes the body refuses raising with the launch count unchanged; fails
   if the WKV6 SASS holds no HMMA.  Then its times at rwkv6-1.6b's
   prefill shapes (``WKV_TIMED_SHAPES``: T 256 in chunks of 32, and a
   20-token prompt as one chunk of 20; H 32, hd 64) over its 24 layers'
   input sets, cold in L2 as a prefill meets them: eager, replayed from a
   CUDA graph of the layer loop (``graph_ms``) and the wrapper's host time
   (``host_ms``); no PyTorch call computes WKV6.
5. SSD kernel vs plain: the same for ``ref.ssd_chunked_ref`` (``SSD_CASES``
   in f32 and bf16: T 96, 37 as one chunk of 37, and 384; in bf16 also
   ``SSD_BF16_CASES``: T 1, 17 and 37 as one chunk, T = L, 2L, 3L at L
   128, a ragged chunk of 40, h0 absent and non-zero, every template of
   the bf16 body: P 16, 32 and 64 with N up to 64 and up to 128); two
   calls bit-equal at the prefill shape, bf16 shapes the body refuses
   raising with the launch count unchanged; fails if the SSD SASS holds no
   HMMA.  Then timed as phase 4, over zamba2-2.7b's 54 layers' input sets,
   at its prefill shapes (``SSD_TIMED_SHAPES``: T 384, 128 and 20; H 80,
   P = N = 64); no PyTorch call computes it.
6. model: rhapsody-demo (full config, f32): the paged engine's greedy
   transcripts equal the contiguous prefill + decode_step oracle's.
7. launcher: ``repro_torch.launch.serve`` with its defaults (rhapsody-demo,
   2 replicas, 16 requests), then ``--arch llama3.2-3b`` (its smoke
   config, head_dim 8), ``--arch qwen3-8b`` (16), paged and with
   ``--no-paged``, and ``--arch deepseek-moe-16b`` (MoE, 16;
   ``SERVE_RUNS``).
8. serving main path at full width: llama3.2-3b (bf16, 28 layers, random
   weights from a seed) behind ``Rhapsody`` with 2 replicas, 16 requests
   of 32 new tokens, served twice (cold, then warm).
9. state models, f32 on the card: rwkv6-1.6b (2 layers) and zamba2-2.7b
   (2 groups) at full width, and rhapsody-demo, through the slot engine
   (``paged=False``): greedy transcripts against a recurrent oracle on the
   card that runs no kernel, teacher-forced on the engine's transcript.
   Then zamba2-2.7b's ``forward`` (SSD and flash kernels, head_dim 80) on
   one prompt: f32 cut to 12 layers against the same oracle's logits
   (2 flash launches), and bf16 at 54 layers, finite (9 flash launches),
   timed cold and three times warm.
10-11. slot-pool serving at full width: rwkv6-1.6b (24 layers, d 2048,
   vocab 65536) and zamba2-2.7b (54 layers, d 2560, vocab 32000), bf16,
   random weights from seed 0, behind ``Rhapsody`` with 2 replicas
   through the default ``LLMServicer`` (auto: the slot pool), 16 requests
   of 32 new tokens, cold then warm; prompts up to 400 tokens (rwkv6) and
   256/384-token ones (zamba2) besides the log-normal ones.
12. flash kernel vs plain: out and lse against ``ref.attention_fwd_ref``
   (rhapsody-demo heads, D 32, in f32; zamba2-2.7b's, D 80,
   llama3.2-3b's, D 128, and internvl2-1b's, Hq 14 over Hkv 2 at D 64, in
   f32 and bf16; B 2, S in ``FLASH_SEQS``, the
   edges of the 128-row query tiles and the diagonal tile; the same limits
   as phase 2), and the gradient of ``FlashAttention`` against autograd of
   the plain version in float32 (1e-4 for f32 inputs, 2e-2 for bf16).
13. flash at the llama3.2-3b training shape (B 2, S 2048, Hq 24, Hkv 8,
   D 128, bf16), at zamba2-2.7b's (B 1, S 384, Hq = Hkv = 32, D 80) and at
   phase 29's (internvl2-1b: B 2, S 2304, Hq 14, Hkv 2, D 64;
   whisper-small: B 2, S 448, Hq = Hkv = 12, D 64):
   the wrapper's out, lse and gradient against the plain version as in
   phase 12, then the times of the kernel, the plain version, the library
   yardstick (SDPA, causal, GQA) and the bound (and ``attention_bwd`` at
   the training shape); fails if the flash SASS holds no HGMMA or no
   UTMALDG.
14. train step: rhapsody-demo (full config, f32): one step on the card
   equals the same step on the CPU (loss within 1e-5 relative, every
   parameter within atol 2e-5, rtol 2e-3; Adam eps 1e-3, so the first
   update is not the sign of gradients below eps); then 30 steps on the
   synthetic corpus on the card, after which the loss on a batch the steps
   did not see has fallen.
15. trainer launcher: ``repro_torch.launch.train --steps 20``, then
   ``--arch llama3.2-3b --steps 5`` (its smoke config, head_dim 8),
   ``--arch deepseek-moe-16b --steps 3`` (MoE forward and loss), and
   ``--arch rwkv6-1.6b`` and ``--arch zamba2-2.7b`` with ``--steps 3``.
16. training main path at full width: llama3.2-3b (bf16, 28 layers, remat
   full, random weights from seed 0) through ``DataPipeline``,
   ``init_state`` and ``make_train_step``: global batch 2, seq 2048,
   AdamW, 3 steps.
17. MoE model on the card, f32: deepseek-moe-16b at full width (d 2048,
   16 heads of 128, 64 experts top-6, 2 shared, vocab 102400) cut to 2
   layers (layer 0 dense, layer 1 MoE), decode capacity n_experts / top_k
   (``MOE_ARCH``): the paged engine's greedy transcripts in ``direct``
   and ``gather`` decode modes against the kernel-free oracle on the card,
   teacher-forced as in phase 9.  Then ``moe_apply`` on a 512-token chunk
   at capacity factor 1.0 on the training path, so that tokens are
   dropped: two card calls bit-equal, within 1e-4 of the CPU.
18. speculative decoding, f32: phase 17's target and a draft of the same
   config cut to its dense layer (seed 1), paged/paged and paged/slot:
   the plain target engine's transcripts (teacher-forced where they
   differ), 0 <= acceptance <= 1, proposals made.
19. MoE serving at full width: deepseek-moe-16b (bf16, 28 layers, ~16.4 B
   parameters, random weights from seed 0) behind ``Rhapsody`` with 2
   replicas sharing one parameter set, as phase 8; then one engine alone:
   the host time of a decode step of 8 sequences, and one MoE layer's FFN
   on the card beside its bound.
20. speculative decoding at full width, bf16: the 28-layer target with a
   draft sharing its parameters, beside the plain target on the same 8
   requests: acceptance and generated tokens/s of both, at the config's
   decode capacity and at n_experts / top_k (no drops).
21. disaggregated serving, f32 and exact: llama3.2-3b's full width cut to
   2 layers; a prefill engine (``step_prefill_only``) exports 8 sequences
   at their first token, a decode engine imports them (the imported
   blocks, extracted again, bit-equal to the payload) and finishes them:
   the transcripts of a unified engine (teacher-forced where they differ);
   the prefill engine launches no decode kernel.  Then two sequences
   preempted mid-decode resume with the transcript of uninterrupted decode
   and their first-token stamps, and ``generate_stream`` gives
   ``step()``'s tokens.
22. disaggregated serving at full width: llama3.2-3b (bf16, 28 layers,
   random weights from seed 0) behind ``Rhapsody`` as a prefill group and
   a decode group of one replica each over one parameter set, phase 8's
   traffic addressed to the prefill group: every result handed off and
   imported (no recompute), the prefill replica never decodes; TTFT and
   ITL p95s, the payload's bytes and the export and import times, in
   service and alone; then a WFQ servicer on a small pool where a
   high-class request preempts low-class decodes.
23. scan gradients: ``wkv`` at rwkv6-1.6b's shape (H 32, hd 64, chunk 32,
   T 256) and ``ssd`` at zamba2-2.7b's (H 80, P = N = 64, chunk 128, T
   384), f32 and bf16, the initial state absent and set: one forward
   launch a call, outputs with a ``grad_fn`` held to the plain version,
   every input's gradient against autograd of the plain version on the
   card (1e-4 relative for f32, 2e-2 for bf16, as phase 12).
24. state-family training, card vs CPU, f32: rwkv6-1.6b at full width cut
   to 2 layers and zamba2-2.7b cut to one group (6 Mamba2 layers and the
   shared block): every gradient leaf of ``loss`` against the CPU's
   (``STATE_GRAD_TOL``), then one AdamW step at phase 14's tolerances.
25. training at full width: rwkv6-1.6b (bf16, 24 layers) and zamba2-2.7b
   (bf16, 54 layers), remat full, as phase 16: global batch 2, seq 2048,
   AdamW, 3 steps; step time, tok/s, peak memory; then one more step
   under ``torch.profiler`` (its ``wkv6/backward`` / ``ssd/backward`` span,
   the device's busy share inside it); the profiled steps run their full
   width cut to ``PROFILED_LAYERS`` (rwkv6 4 layers, zamba2 12: two
   groups; the profiler's post-processing of every layer took ~2-3 min
   each of the script's 1200 s).
26. workflows: ``heat_stencil``, ``lj_step`` and ``surrogate_eval`` on the
   card against the CPU from one seed, then timed at a 4096^2 heat grid
   over 100 steps and 4096 LJ particles over 10 steps; ``TorchBackend``
   beside the pool backend in one ``Rhapsody``; exp6's agent population
   (8 agents x 4 decisions, 12-token prompts, 16 new tokens,
   ``surrogate_eval`` tools) behind llama3.2-3b at full width (bf16, one
   paged replica); then ``benchmarks_torch`` exp1, exp2 and exp5 on the
   card with no failed suite.
27. encoder-decoder and vision prefix, f32 on the card: whisper-small at
   full width and depth (12 + 12 layers) and internvl2-1b at full width
   (24 layers), random weights from seed 0, through the slot engine (4
   requests, 6 new tokens): every token against an oracle on the card
   that runs no kernel (``slot_oracle``: the engine's zero frontend stub,
   whisper's cross K/V padded to 1500 positions, ``decode_step`` on the
   plain version), teacher-forced as in phase 9; then whisper's
   ``prefill`` over 1500 random frames and 8 ``decode_step``s with the
   kernel against without it (``ENCDEC_F32_TOL``).
28. slot-pool serving at full width: whisper-small and internvl2-1b, bf16,
   random weights from seed 0, behind ``Rhapsody`` with 2 replicas through
   the default ``LLMServicer``, phase 8's traffic (16 requests of 32 new
   tokens, log-normal prompts), cold then warm (``ENCDEC_VLM_ENGINE``:
   internvl2-1b's max_len holds its 256 patches plus the largest bucket).
29. training: one step card vs CPU of each at full width cut to 2 (+ 2)
   layers in f32 (phase 14's tolerances), then both at full width in
   bf16, remat full, AdamW, 3 steps: internvl2-1b at 2 x 2048 text tokens
   after 256 stubbed patches, whisper-small at 2 x 448 tokens over 1500
   stubbed frames; step time, tok/s, peak memory.
30. exp3 (``benchmarks_torch.bench_inference_scaling.run_config``) with
   llama3.2-3b at full width, bf16, one weight set every replica serves,
   phase 8's engine: 1, 2 and 4 replicas with 2 clients each, every client
   8 requests of one 64-token prompt with 32 new tokens; tokens/s (prompt
   plus generated, and generated alone), seconds, utilization,
   per-replica requests, the scaling efficiency tps(n) / (n tps(1)) and
   peak memory of each config.
31. ``--paged``'s three engines (slot pool, paged ``gather``, paged
   ``direct``) with llama3.2-3b at full width in float32 over one weight
   set, the reference's traffic and pool: transcripts equal (a flip only
   under a 1e-5 top-two gap of the kernel-free oracle), the paged rows'
   sharing, copy-on-write and block gauges, both decode kernels launched.
32. the reference's CI bench smokes that touch the card, on the port, as
   subprocesses with ``--device cuda`` (``--paged``, ``--speculative``,
   ``--disagg``, ``bench_routing --affinity`` and ``--replicas 1 2 4``,
   ``bench_agentic --qos``, and the ``kernels`` suite), each JSON judged by
   the reference's ``benchmarks/check_bench_json.py`` as a subprocess; a
   failed gate that compares two timings is printed with its ratio, any
   other failure fails the phase.
33. the dry-run against the card: ``repro_torch.launch.dryrun`` counts, on
   ``meta`` in a CPU process of its own started after the build
   (``--dryrun-worker``; the card hidden from it), llama3.2-3b's four
   ``SHAPES`` cells (``run_cell``: ok, long_500k skipped) and each training
   step that phases 16, 25 and 29 time, at their shapes (llama3.2-3b,
   rwkv6-1.6b, zamba2-2.7b, internvl2-1b at 2 x 2048, whisper-small at 2 x
   448).  For each step: its bound max(t_compute, t_memory) at most the
   fastest warm step the card timed (else the counter counts work twice
   or charges a kernel wrongly), the share bound / measured and the
   model-FLOP share 6 N D / (measured x 989 TFLOP/s), the parameters' and
   AdamW state's bytes equal to what the card holds for them, the
   estimated peak beside ``max_memory_allocated``.  Then llama3.2-3b's
   and nemotron-4-340b's train_4k cells on the 16 x 16 and 2 x 16 x 16
   production meshes (this worker rank 0 of a ``fake`` process group of
   256 / 512, DTensors on ``meta``): ok, per-device FLOPs, bytes and
   collective bytes, the roofline at the H100 data sheet's rates.
34. remat "dots" against "full": llama3.2-3b at full width, bf16, one
   loss-and-gradient step at 2 x 2048 on the same weights and batch under
   each: the losses equal, every gradient leaf within the bf16 gradient
   tolerance, the flash kernel launched 2 x n_layers under both (its
   forward recomputed under dots too); each one's warm time and peak
   memory; then the counter's FLOPs (the worker's, on meta): dots below
   full by exactly full's recomputed mm/addmm FLOPs, and dots's mm FLOPs
   those of remat none.
35. training under a mesh on one card: llama3.2-3b at full width (bf16,
   remat full) with ``explicit_tp``, ``fsdp_params`` and
   ``seq_shard_activations``, 2 x 2048, on a 1 x 1 ``("data", "model")``
   mesh of this card (NCCL, one rank; every collective a size-1 group's):
   the loss and every gradient leaf of the step's own
   ``train.microbatch_grads`` against the unsharded step's on the same
   weights and batch (loss within 1e-4 relative: the vocab-sharded
   log-likelihood sums in another order; each leaf within a relative norm
   of 5e-2 and 1e-4 elementwise, ``MESH_GRAD_REL_NORM``), the flash kernel
   launched as often (2 x n_layers); then two sharded AdamW steps, timed.
36. four ranks on one card: four gloo processes share this card in a 2 x
   2 mesh (NCCL refuses two ranks on one device; gloo's all-gather of CUDA
   tensors crashes, so it is staged through host memory by
   ``launch/mesh.stage_all_gather_through_host``, counted and printed;
   every other collective runs on the card's tensors), smoke widths in
   f32 (``MESH_CASES``): rhapsody-demo with explicit TP, FSDP and SP,
   deepseek-moe-16b expert-parallel (capacity n_experts / top_k: no
   drops), zamba2-2.7b and rwkv6-1.6b.  Each one sharded AdamW step
   against the one-rank step on the card from the same weights and batch
   (loss within 1e-5 relative, every parameter within atol 2e-5, rtol
   2e-3, Adam eps 1e-3 as phase 14); each rank's flash / SSD / WKV6
   launches, on its local shards, equal to the one-rank step's.  Then one
   case at full width, depth cut: llama3.2-3b's first 2 layers with TP,
   FSDP and SP in bf16 at 2 x 2048, its sharded loss and gradient against
   the one-rank ones on rank 0 (phase 35's limits), each rank's flash
   launches equal to them and its flash inputs the local shard's (batch
   1, 12 of 24 heads after the K/V repeat: G 1, D 128, S 2048).

Every phase that drives a path sets all five kernels' launch counts to 0
just before it runs and checks every count just after: the paged serving
phases launch the paged decode kernel n_layers x decode steps times (the
contiguous one in ``gather`` mode); a speculative session launches its
draft's decode kernel n_layers x draft steps times and, verifying through
``extend``, none for the target; a disaggregated pair launches the paged
kernel n_layers x the decode engine's decode steps, none for the prefill
engine; the
slot-pool phases launch WKV6 n_layers x prefills (rwkv6), SSD n_layers x
prefills and the contiguous decode n_layers / attn_every x decode steps
(zamba2), or the contiguous decode n_layers x decode steps (dense,
internvl2-1b; 2 x n_layers for whisper-small: self and cross attention); a
training phase launches the flash kernel 2 x n_layers x steps times (remat
runs each block's forward again), for rwkv6 WKV6 2 x n_layers x steps, for
zamba2 SSD 2 x n_layers and flash 2 x n_layers / attn_every x steps (the
scans' backward runs the plain version and launches nothing), zamba2's
forward SSD n_layers and flash n_layers / attn_every times; the agent
population the paged decode kernel n_layers x decode steps; the payloads
and benchmark suites none; exp3 the paged kernel n_layers x the
replicas' decode steps; the f32 paged comparison the paged kernel for the
direct engine and the contiguous one for the slot pool and the gather
engine; every other kernel never.  Any failure
exits non-zero.  Each phase's line carries ``elapsed_s``, the script's
seconds up to its end.  The last lines are the five kernels' JSON record
(the decode pair's, the flash kernel's and the scans' rows also carry
``graph_ms``, and the attention kernels' ``library_graph_ms``; every row
``launches_by_path``, its launches on each full-width path), the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.  Without a
CUDA card it exits 2 and prints no result.
"""
import atexit
import concurrent.futures
import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _own_module(rel):
    """A module of this checkout loaded by path, outside the
    ``repro_torch`` package: the bench scripts import this file and then
    time another tree's kernels (``--src``), which the package must then
    come from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# each kernel's work (bytes, operations), the formula the dry-run charges
# it, and the H100 data sheet's HBM3 rate and dense bf16 tensor-core peak,
# the dry-run's constants
kernel_cost = _own_module("src/repro_torch/kernels/cost.py")
H100_BYTES_PER_S, H100_BF16_FLOPS = kernel_cost.HBM_BW, kernel_cost.PEAK_FLOPS
DEVICE = "cuda"
# kernel vs plain, (atol, rtol): f32 differs only in summation order; bf16
# outputs are rounded to bf16 on both sides, so allow 4e-3 plus one bf16
# ulp (2^-7) of the value
F32_TOL = (2e-5, 2e-5)
BF16_TOL = (4e-3, 2.0 ** -7)

# the main path's model and engine (phase 8; profile_engine.py uses them too)
MAIN_PATH_ARCH = "llama3.2-3b"
MAIN_PATH_NEW_TOKENS = 32
MAIN_PATH_ENGINE = dict(max_num_seqs=8, max_num_batched_tokens=512,
                        max_len=1024, prefill_buckets=(16, 32, 64),
                        paged=True, block_size=16)
# the training main path (phase 16)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
# the encoder-decoder and vision-prefix families (phases 27-29): Whisper's
# audio and text contexts (30 s of audio at 50 frames/s; arXiv:2212.04356)
# and internvl2-1b's patches a image
WHISPER_AUDIO_FRAMES, WHISPER_TEXT_CTX = 1500, 448
VISION_TOKENS = 256
ENCDEC_VLM_ARCHS = ("whisper-small", "internvl2-1b")
# their slot engines: the default buckets (32 ... 512); internvl2-1b's
# max_len holds its 256 patches plus the largest bucket (a prefill past
# max_len raises, as the reference's does)
ENCDEC_VLM_ENGINE = {
    "whisper-small": dict(max_num_seqs=8, max_num_batched_tokens=1024,
                          max_len=512),
    "internvl2-1b": dict(max_num_seqs=8, max_num_batched_tokens=1024,
                         max_len=1024)}
# whisper-small in f32 through 24 layers at d 768: decode kernel vs plain
# (within 2e-5 each) summed in another order, as HYBRID_F32_TOL
ENCDEC_F32_TOL = (1e-3, 1e-3)
# gradients of the flash kernel's Function vs autograd of the plain version
# in float32: 1e-4 for f32 inputs; 2e-2 for bf16 (the reference's own bf16
# limit for this kernel, tests/test_kernels.py)
F32_GRAD_TOL, BF16_GRAD_TOL = 1e-4, 2e-2
# the flash checks' sequence lengths: the 128-row query tiles' edges and
# the diagonal tile, ragged and whole
FLASH_SEQS = (1, 63, 64, 65, 127, 128, 129, 200, 1024, 2048)
# zamba2's training forward (SSD and flash kernels) vs the kernel-free
# oracle, last-position logits in float32 through 12 layers at d 2560:
# chunked scan vs recurrence and tiled vs one-pass softmax sum in another
# order (the CPU parity tests hold 1e-4 at smoke width)
HYBRID_F32_TOL = (1e-3, 1e-3)


# the slot-pool serving of the state-carrying families (phases 9-11)
STATE_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
STATE_ENGINE = dict(max_num_seqs=8, max_num_batched_tokens=1024, max_len=512)
ZAMBA_ATTN_LAYERS = 9  # zamba2-2.7b: 54 mamba layers, the shared block
#                        after every 6
WKV_SHAPE = (1, 256, 32, 64, 32)  # rwkv6-1.6b prefill: B, T, H, hd, chunk
SSD_SHAPE = (1, 384, 80, 64, 64, 128)  # zamba2-2.7b prefill: B, T, H, P, N, L
# WKV/SSD kernel vs plain in float32: 1e-4 relative with the same floor,
# the reference's own limit for these scans (tests/test_kernels.py): exps
# and chunk sums taken in another order
SCAN_F32_TOL = (1e-4, 1e-4)
# an f32 engine token may differ from the kernel-free oracle's only where
# the oracle's top-two logits are closer than this (ROADMAP's rule)
MODEL_GAP_TOL = 1e-3
# the MoE phases (17-20): deepseek-moe-16b at full width.  Phase 17's f32
# model takes a decode capacity factor of n_experts / top_k, room for every
# token of a batch in every expert: the reference's capacity is per batch
# (at the config's 4.0 an expert takes at most 37.5 % of a batch's
# tokens), so only without drops can the batched engine be held to a
# one-sequence oracle.  The drops are held by the capacity-overflow check:
# a prefill chunk of MOE_OVERFLOW_T tokens at capacity factor 1.0, card vs
# the CPU within MOE_CPU_TOL (f32 sums in another order over d 2048)
MOE_ARCH = "deepseek-moe-16b"
MOE_OVERFLOW_T = 512
MOE_CPU_TOL = 1e-4
SPEC_K = 3  # proposals a speculative round (phases 18 and 20)
# phase 25: the profiled steps at their full width cut to these depths
# (the profiler's post-processing of every layer took ~2-3 min each)
PROFILED_LAYERS = {"rwkv6-1.6b": 4, "zamba2-2.7b": 12}
# phase 36: four gloo ranks sharing the card in a 2 x 2 mesh, smoke widths
MESH_WORLD = 4
MESH_TP = dict(explicit_tp=True, fsdp_params=True, seq_shard_activations=True)
MESH_CASES = (("rhapsody-demo", MESH_TP), ("deepseek-moe-16b", "nodrop"),
              ("zamba2-2.7b", {}), ("rwkv6-1.6b", {}))
MESH_BATCH, MESH_SEQ = 4, 64
# and one case at full width, depth cut: llama3.2-3b's 2 layers with TP,
# FSDP and SP in bf16 at TRAIN_BATCH x TRAIN_SEQ, so the flash kernel runs
# on each rank's local shard at the production shapes (batch 1, 12 of 24
# heads after the K/V repeat: G 1, D 128, S 2048)
MESH_FULL_LAYERS = 2
# phases 35-36: a sharded bf16 gradient leaf against the unsharded one by
# its relative norm |g1 - g0| / |g0| and elementwise, the loss relatively.
# Read on the H100: relative norms up to 1.64e-2 on 1 x 1 (28 layers: the
# two paths round bf16 in another order and the backward carries it down
# the layers) and 1.17e-2 on 2 x 2 (2 layers), elements within 4.2e-5;
# a zeroed leaf reads 1, a sign-flipped or doubled one 2 or 1
MESH_GRAD_REL_NORM, MESH_GRAD_ATOL, MESH_LOSS_TOL = 5e-2, 1e-4, 1e-4


def main_path_prompt_lens(rng, n):
    """Log-normal prompt lengths (median ~20 tokens) that fit max_len."""
    hi = MAIN_PATH_ENGINE["max_len"] - MAIN_PATH_NEW_TOKENS - 1
    return np.clip(np.exp(rng.normal(3.0, 0.7, n)), 4, hi).astype(int)


START = time.perf_counter()  # the script's start (each phase's elapsed_s)


def emit(obj):
    """Print ``obj`` as one JSON line; a phase's line also carries
    ``elapsed_s``, the script's seconds up to its end."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


# kernel name -> (its wrapper module, the wrapper's launch counter); main()
# fills it after the imports
COUNTERS = {}


def zero_launches():
    """Set every kernel's launch count to 0 (just before a phase's run)."""
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def check_launches(where, **expected):
    """Every kernel's launches since ``zero_launches()``: the named ones
    must equal ``expected``, every other kernel must not have run."""
    got = {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}
    want = {name: expected.get(name, 0) for name in COUNTERS}
    check(got == want, f"{where}: launches {got} != expected {want}")
    return got


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def within(got, plain, tol):
    """(max |got - plain|, whether |got - plain| <= atol + rtol |plain|
    everywhere) for tol = (atol, rtol)."""
    atol, rtol = tol
    diff = (got.float() - plain.float()).abs()
    return float(diff.max()), bool(
        (diff <= atol + rtol * plain.float().abs()).all())


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


def ptxas_entries(text):
    """Each kernel's registers and spill bytes from nvcc's ``-Xptxas -v``
    output, its name demangled by ``cu++filt``."""
    import re

    from repro_torch.kernels import build

    entries = []
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entries.append({"entry": m[1]})
        elif entries and "spill stores" in ln:
            stores, loads = re.findall(r"(\d+) bytes spill", ln)
            entries[-1].update(spill_stores=int(stores),
                               spill_loads=int(loads))
        elif entries and (m := re.search(r"Used (\d+) registers", ln)):
            entries[-1]["registers"] = int(m[1])
    if entries:
        names = subprocess.run(
            [build.cuda_tool("cu++filt"), *(e["entry"] for e in entries)],
            capture_output=True, text=True, check=True).stdout.splitlines()
        for e, name in zip(entries, names):
            e["entry"] = name
    return entries


def sass_counts(path):
    """Hopper instructions in a built library's SASS (``cuobjdump -sass``):
    HGMMA (wgmma), HMMA (mma.sync), UTMALDG and UTMASTG (TMA loads and
    stores), SYNCS (mbarrier operations)."""
    from repro_torch.kernels import build

    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()
    return {op: sum(op in ln for ln in sass)
            for op in ("HGMMA", "HMMA", "UTMALDG", "UTMASTG", "SYNCS")}


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


# every decode head dim, as (label, Hkv, G, D): the heads of the configs
# that run each width (llama3.2-3b and nemotron-4-340b smoke: D 8;
# qwen3-8b, qwen1.5-0.5b and zamba2-2.7b smoke: 16; rhapsody-demo: 32;
# zamba2-2.7b: 80; llama3.2-3b: 128), D 64 at four query heads a group, and
# internvl2-1b's seven query heads a group (its smoke config: D 8; full: 64)
DECODE_HEADS = (("llama3.2-3b-smoke", 2, 3, 8), ("qwen3-8b-smoke", 2, 2, 16),
                ("rhapsody-demo", 4, 2, 32), ("d64-group4", 2, 4, 64),
                ("zamba2-2.7b", 32, 1, 80), ("llama3.2-3b", 8, 3, 128),
                ("internvl2-1b-smoke", 1, 7, 8), ("internvl2-1b", 2, 7, 64))
# whisper-small's cross-attention decode: B 8, 12 kv heads of one query
# head, D 64, every row over the slot's 1500 cross positions
WHISPER_CROSS = (8, 12, 1, 64, 1500)


def graph_ms(torch, fn, reps):
    """Device time per replay of a CUDA graph that captures one call of
    ``fn`` (no host dispatch inside the replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms


def host_ms(torch, fn, reps, trials=7):
    """Host wall time to issue one call of ``fn``, with no sync inside:
    the median over ``trials`` runs of ``reps`` calls (the host's clock
    varies more than the card's)."""
    times = []
    for _ in range(trials):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e3)
        torch.cuda.synchronize()
    return sorted(times)[trials // 2]


def decode_times(torch, L, kernel, wrapper, plain, library):
    """Per-layer-call times of a decode kernel over ``L`` layer caches,
    each argument a function of the layer: the raw kernel eagerly
    (``kernel_ms``, and again at the end) and replayed from a CUDA graph of
    the L-layer loop (``graph_ms``); the host's time to issue the wrapper
    the model calls (``host_ms``); the plain version; the library
    yardstick eagerly, from a graph, and its host time."""
    def loop(fn):
        return lambda: [fn(layer) for layer in range(L)]

    t = {"kernel_ms": cuda_ms(loop(kernel), 20) / L}
    t["plain_ms"] = cuda_ms(loop(plain), 3) / L
    t["library_ms"] = cuda_ms(loop(library), 5) / L
    t["library_graph_ms"] = graph_ms(torch, loop(library), 20) / L
    t["library_host_ms"] = host_ms(torch, loop(library), 20) / L
    t["graph_ms"] = graph_ms(torch, loop(kernel), 20) / L
    t["host_ms"] = host_ms(torch, loop(wrapper), 20) / L
    t["kernel_ms_repeat"] = cuda_ms(loop(kernel), 20) / L
    return t


def split_lens(rows, splits, cap):
    """Lengths at the tile edges, at and around each split boundary, that
    leave late split ranks empty, and at and past the cache's end."""
    edges = {1, rows - 1, rows, rows + 1, rows * (splits - 1) + 1,
             cap - 1, cap, cap + 1, cap + 500}
    for k in (1, 2, 3):
        edges |= {k * rows * splits - 1, k * rows * splits,
                  k * rows * splits + 1}
    return sorted(n for n in edges if n >= 1)


def phase_split_edges(torch, ops, ref, kernel):
    """Both decode entry points where the split of a sequence across a
    cluster's blocks has its edges: one kv head of one sequence plus two
    engine-style padding rows (length 1, all-null tables), a 1,024-position
    cache, every head dim in f32 and bf16, at every length of
    ``split_lens``: against the plain versions, two calls bit-equal,
    relocated blocks bit-equal."""
    rng = np.random.RandomState(9)
    bs, mb, G = 16, 64, 3
    cap = bs * mb
    records, worst = [], 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for D in ops.KERNEL_HEAD_DIMS:
            rows = 16 if D * dtype.itemsize >= 128 else 32
            splits, warps = kernel.launch_shape(dtype, 3, 1, G, D, cap)
            check(splits > 1, f"split edges D {D}: no split ({splits})")
            lens = split_lens(rows, splits, cap)
            err_d = 0.0
            for n in lens:
                ks, vs, q, bt, ln = paged_inputs(
                    torch, rng, L=1, B=1, Hkv=1, G=G, D=D, bs=bs, mb=mb,
                    num_blocks=mb + 1, lens=[min(n, cap)], dtype=dtype,
                    pad_rows=2)
                ln[0] = n
                ks, vs = ks[0], vs[0]
                out = ops.paged_decode_attention(q, ks, vs, bt, ln)
                again = ops.paged_decode_attention(q, ks, vs, bt, ln)
                plain = ref.paged_decode_ref(q.reshape(3, 1, G, D), ks, vs,
                                             bt, ln).reshape(out.shape)
                perm = torch.from_numpy(np.concatenate(
                    [[0], 1 + rng.permutation(mb)])).to(DEVICE)
                inv = torch.argsort(perm)
                moved = ops.paged_decode_attention(
                    q, ks[inv].contiguous(), vs[inv].contiguous(),
                    perm[bt.long()].to(torch.int32), ln)
                kc, vc = (ref.gather_kv(t, bt).contiguous()
                          for t in (ks, vs))
                slot = ops.decode_attention(q, kc, vc, ln)
                slot_again = ops.decode_attention(q, kc, vc, ln)
                torch.cuda.synchronize()
                err, ok = within(out, plain, tol)
                serr, sok = within(slot, plain, tol)
                check(ok and sok, f"split edges D {D} {dtype} len {n}: "
                                  f"errors {err} (paged), {serr} (slot)")
                check(torch.equal(out, again)
                      and torch.equal(slot, slot_again),
                      f"split edges D {D} {dtype} len {n}: two calls differ")
                check(torch.equal(out, moved),
                      f"split edges D {D} {dtype} len {n}: relocation "
                      f"changed the output")
                err_d = max(err_d, err, serr)
            worst = max(worst, err_d)
            records.append({"dtype": str(dtype).split(".")[-1], "D": D,
                            "rows_per_tile": rows, "splits": splits,
                            "warps": warps,
                            "lens": lens, "max_err": err_d,
                            "deterministic": True, "relocation_exact": True})
    return records, worst


def paged_timing(torch, ops, ref, kernel, rng):
    """The paged kernel at the llama3.2-3b main-path decode shape: 28 layer
    stores as the engine holds them (1.9 GB, so each call finds its layer
    cold in the 50 MB L2), batch 8, lengths around 512, max_len 1024; held
    against the plain version on the first and last layer, then timed
    (``decode_times``) beside the bound."""
    L, B, Hkv, G, D, bs, mb, N = 28, 8, 8, 3, 128, 16, 64, 513
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
        plain = ref.paged_decode_ref(qg, ks[layer], vs[layer], bt, ln)
        err, ok = within(got.reshape(plain.shape), plain, BF16_TOL)
        check(ok, f"llama3.2-3b main shape: kernel vs plain error {err}")
        main_err = max(main_err, err)

    def run_kernel(layer):
        err = kernel.paged_decode_attention_grouped(
            qg, ks[layer], vs[layer], bt, ln, out, scale)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    S = mb * bs
    mask = (torch.arange(S, device=DEVICE)[None, :] < ln[:, None].long()
            )[:, None, None, :]  # [B, 1, 1, S]
    kc = [ref.gather_kv(ks[layer], bt).transpose(1, 2).contiguous()
          for layer in range(L)]  # [B, Hkv, S, D]
    vc = [ref.gather_kv(vs[layer], bt).transpose(1, 2).contiguous()
          for layer in range(L)]
    qs = q.transpose(1, 2).contiguous()  # [B, Hq, 1, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = decode_times(
        torch, L, run_kernel,
        lambda layer: ops.paged_decode_attention(q, ks[layer], vs[layer],
                                                 bt, ln),
        lambda layer: ref.paged_decode_ref(qg, ks[layer], vs[layer], bt, ln),
        lambda layer: sdpa(qs, kc[layer], vc[layer], attn_mask=mask,
                           enable_gqa=True))
    flops, bytes_moved = kernel_cost.paged_decode_attention(
        q, ks[0], bt, sum(lens))  # the K and V rows attended
    bms, by = bound_ms(bytes_moved, flops, H100_BF16_FLOPS)
    shape = getattr(kernel, "launch_shape", None)  # older trees lack it
    timing = {"config": "llama3.2-3b", "layers": L, "B": B, "lens": lens,
              "block_size": bs, "max_blocks": mb, "num_blocks": N,
              "splits_warps": shape(torch.bfloat16, B, Hkv, G, D, S)
              if shape else None, **times, "bound_ms": bms, "bound_by": by,
              "bytes": bytes_moved, "flops": flops, "max_err": main_err,
              "achieved_GBps": bytes_moved / (times["kernel_ms"] * 1e-3)
              / 1e9}
    del ks, vs, kc, vc
    torch.cuda.empty_cache()
    return timing


def phase_kernel(torch, ops, ref, kernel):
    """Kernel vs plain on the card at every head dim; the split's edges;
    times at the llama3.2-3b decode shape."""
    rng = np.random.RandomState(0)
    bs = 16
    cases = []
    worst = 0.0
    for label, Hkv, G, D in DECODE_HEADS:
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            atol, rtol = tol
            name = f"{label}-{str(dtype).split('.')[-1]}"
            mb = 16
            lens = [1, bs - 1, bs, bs + 1, mb * bs, 37, 100, 200]
            ks, vs, q, bt, ln = paged_inputs(
                torch, rng, L=1, B=len(lens), Hkv=Hkv, G=G, D=D, bs=bs,
                mb=mb, num_blocks=160, lens=lens, dtype=dtype, pad_rows=2)
            out = ops.paged_decode_attention(q, ks[0], vs[0], bt, ln)
            n = q.shape[0]
            plain = ref.paged_decode_ref(q.reshape(n, Hkv, G, D), ks[0],
                                         vs[0], bt, ln).reshape(out.shape)
            torch.cuda.synchronize()
            err, ok = within(out, plain, tol)
            check(ok, f"{name}: kernel vs plain max error {err} > "
                      f"{atol} + {rtol} x |plain|")
            # relocate physical blocks: output must not change at all
            perm = torch.from_numpy(np.concatenate(
                [[0], 1 + rng.permutation(ks.shape[1] - 1)])).to(DEVICE)
            inv = torch.argsort(perm)
            out2 = ops.paged_decode_attention(
                q, ks[0][inv].contiguous(), vs[0][inv].contiguous(),
                perm[bt.long()].to(torch.int32), ln)
            check(torch.equal(out, out2),
                  f"{name}: relocation changed output")
            worst = max(worst, err)
            cases.append({"config": name, "dtype": str(dtype).split(".")[-1],
                          "Hkv": Hkv, "G": G, "D": D, "block_size": bs,
                          "lens": lens, "pad_rows": 2, "max_err": err,
                          "atol": atol, "rtol": rtol,
                          "relocation_exact": True})
    edges, edge_worst = phase_split_edges(torch, ops, ref, kernel)
    timing = paged_timing(torch, ops, ref, kernel, rng)
    worst = max(worst, edge_worst, timing["max_err"])
    return cases, edges, timing, worst


def phase_model(torch, configs, get_model, engine_mod):
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
        paged=True, block_size=16)
    zero_launches()
    uids = [eng.submit(p, max_new_tokens=steps) for p in prompts]
    done = eng.run()
    torch.cuda.synchronize()
    launches = check_launches("model", paged_decode_attention=cfg.n_layers
                              * eng.stats.decode_steps)[
        "paged_decode_attention"]
    got = [done[u].output for u in uids]
    check(got == oracle, f"paged transcripts {got} != oracle {oracle}")
    check(launches > 0, "model: no decode step ran")
    return {"prompts": len(prompts), "new_tokens": steps,
            "transcripts_equal": True, "launches": launches,
            "decode_steps": eng.stats.decode_steps}


# the serve launcher's runs in phase 7: (arch, extra flags, the decode
# kernel it must launch n_layers times a decode step); every arch but
# rhapsody-demo serves its smoke config (head_dim 8 for llama3.2-3b, 16
# for qwen3-8b and deepseek-moe-16b)
SERVE_RUNS = (("rhapsody-demo", [], "paged_decode_attention"),
              ("llama3.2-3b", [], "paged_decode_attention"),
              ("qwen3-8b", [], "paged_decode_attention"),
              ("qwen3-8b", ["--no-paged"], "decode_attention"),
              ("deepseek-moe-16b", [], "paged_decode_attention"))


def phase_launcher(serve, configs):
    """The serve launcher: its defaults (rhapsody-demo, 2 replicas, 16
    requests), then llama3.2-3b, qwen3-8b (paged and slot pool) and
    deepseek-moe-16b."""
    runs = []
    for arch, flags, kern in SERVE_RUNS:
        argv = ([] if arch == "rhapsody-demo" else ["--arch", arch]) + flags
        cfg = (configs.get_config(arch) if arch == "rhapsody-demo"
               else configs.get_smoke_config(arch))
        zero_launches()
        t0 = time.perf_counter()
        out = serve.main(argv + ([] if DEVICE == "cuda"
                                 else ["--device", DEVICE]))
        where = f"launcher {' '.join(argv) or '(defaults)'}"
        launches = check_launches(
            where, **{kern: cfg.n_layers * out["decode_steps"]})[kern]
        res = out["results"]
        check(len(res) == 16 and all(len(r["tokens"]) == 8 for r in res),
              f"{where}: a request came back short")
        check(all(e is None for e in out["errors"]),
              f"{where}: replica errors {out['errors']}")
        check(launches > 0, f"{where}: no decode step ran")
        runs.append({"argv": argv, "head_dim": cfg.head_dim,
                     "kernel": kern, "requests": len(res),
                     "launches": launches,
                     "decode_steps": out["decode_steps"],
                     "seconds": time.perf_counter() - t0})
    return runs


def p95(xs):
    xs = sorted(xs)
    return xs[int(len(xs) * 0.95)]


def serve_pass(torch, core, rh, cfg, rng, lens, mnt, where, model=None):
    """One pass of the main path's traffic through ``rh``: fresh prompts
    of ``lens`` (addressed to group ``model`` when given), greedy, ``mnt``
    new tokens each.  -> (prompts, results, record)."""
    prompts = [list(map(int, rng.randint(0, cfg.vocab, size=int(n))))
               for n in lens]
    extra = {} if model is None else {"model": model}
    descs = [core.TaskDescription(
        kind=core.TaskKind.INFERENCE, service="llm",
        payload={"prompt": p, "max_new_tokens": mnt, **extra},
        task_type="inference") for p in prompts]
    t0 = time.perf_counter()
    uids = rh.submit(descs)
    check(rh.wait(uids, timeout=600), f"{where} timed out")
    results = [rh.result(u) for u in uids]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(all(len(r["tokens"]) == mnt for r in results),
          f"{where}: a request came back short")
    check(all(0 <= t < cfg.vocab for r in results for t in r["tokens"]),
          f"{where}: a token outside the vocabulary")
    lat = sorted(r["latency_s"] for r in results)
    gen_tokens = sum(len(r["tokens"]) for r in results)
    all_tokens = gen_tokens + sum(r["n_prompt"] for r in results)
    return prompts, results, {
        "seconds": dt, "tok_per_s": all_tokens / dt,
        "gen_tok_per_s": gen_tokens / dt,
        "latency_p50_s": lat[len(lat) // 2], "latency_p95_s": p95(lat),
        "ttft_p95_s": p95([r["ttft_s"] for r in results]),
        "itl_p95_s": p95([r["itl_s"] for r in results])}


def phase_main_path(torch, configs, core, client, cfg=None, params=None):
    """llama3.2-3b at full width behind Rhapsody: 2 replicas, 16 requests,
    served twice with fresh prompts of the same lengths.  The first pass
    pays every first call (matmul shapes, allocator growth); the second
    is warm.  Phase 19 passes another ``cfg`` and the ``params`` both
    replicas serve (one parameter set, not a copy each)."""
    cfg = cfg or configs.get_config(MAIN_PATH_ARCH)
    where = "main path" if params is None else cfg.name
    replicas, n_req, mnt = 2, 16, MAIN_PATH_NEW_TOKENS
    rh = core.Rhapsody(core.ResourceDescription(nodes=replicas,
                                                cores_per_node=16),
                       n_workers=2)
    try:
        t_up = time.perf_counter()
        rs = rh.add_service(core.ServiceDescription(
            name="llm", replicas=replicas, ready_timeout=600,
            factory=client.llm_service_factory(
                cfg, params, device=DEVICE, **MAIN_PATH_ENGINE)))
        setup_s = time.perf_counter() - t_up
        rng = np.random.RandomState(0)
        lens = main_path_prompt_lens(rng, n_req)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        prompts, _, cold = serve_pass(torch, core, rh, cfg, rng, lens, mnt,
                                      where)
        _, _, warm = serve_pass(torch, core, rh, cfg, rng, lens, mnt, where)
        errors = [inst.error for inst in rs.instances]
        decode_steps = sum(inst.servicer.stats.decode_steps
                           for inst in rs.instances)
        launches = check_launches(
            where, paged_decode_attention=cfg.n_layers * decode_steps)[
            "paged_decode_attention"]
        stats = rs.stats()
        check(all(e is None for e in errors), f"replica errors {errors}")
        check(launches > 0, f"{where}: no decode step ran")
        # the served weights give finite logits of the expected shape
        eng = rs.instances[0].servicer.engine
        _, logits = eng.api.prefill(
            eng.params, {"tokens": torch.tensor([prompts[0]], device=DEVICE)},
            cfg, max_len=eng.max_len)
        check(tuple(logits.shape) == (1, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"{where}: prefill logits not finite")
        return {"config": cfg.name, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "vocab": cfg.vocab,
                "dtype": cfg.compute_dtype, "replicas": replicas,
                "shared_params": params is not None,
                "requests_per_pass": n_req, "max_new_tokens": mnt,
                "prompt_lens": [int(x) for x in lens],
                "setup_seconds": setup_s, "cold": cold, "warm": warm,
                "launches": launches, "decode_steps": decode_steps,
                "per_replica_requests": [p["requests"]
                                         for p in stats["per_replica"]],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        rh.close()


# ---------------------------------------------------------------------------
# Slot-pool serving of the state-carrying families (rwkv6, zamba2): the
# contiguous flash-decode, WKV6 and SSD kernels
# ---------------------------------------------------------------------------


def bound_ms(bytes_moved, ops, rate):
    """The least time for the work: bytes at 3.35 TB/s or operations at
    ``rate``, whichever is longer -> (ms, what bounds it)."""
    byte_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    op_ms = ops / rate * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms
                                 else "operations")


def card_randn(torch, gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEVICE)
            * scale).to(dtype)


def state_prompt_lens(rng, arch, n):
    """The serving phases' prompt lengths: log-normal (median ~20 tokens)
    up to 128, plus, for rwkv6, four of 100-400 tokens (padding and several
    32-token chunks) and, for zamba2, 256, 384 and 256 (several 128-token
    chunks; zamba2 prefills at most ``ssm_chunk`` tokens or a multiple of
    it, as the reference)."""
    lens = np.clip(np.exp(rng.normal(3.0, 0.7, n)), 4, 128).astype(int)
    long = (rng.randint(100, 401, size=4) if arch == STATE_ARCHS[0]
            else np.asarray([256, 384, 256]))
    lens[3:3 + 4 * len(long):4] = long
    return lens


def decode_timing(torch, ops, ref, kernel, name, L, B, Hkv, G, D, S, lens):
    """The contiguous decode kernel over ``L`` layer caches [B, S, Hkv, D]
    in bf16, as an engine holds them (cold in the 50 MB L2 each call):
    held against the plain version on the first and last layer, then timed
    beside it, SDPA (GQA, length mask) and the bound."""
    lens = [int(n) for n in lens]
    gen = torch.Generator(device=DEVICE).manual_seed(L)
    bf16 = torch.bfloat16
    kc = card_randn(torch, gen, (L, B, S, Hkv, D), bf16)
    vc = card_randn(torch, gen, (L, B, S, Hkv, D), bf16)
    q = card_randn(torch, gen, (B, 1, Hkv * G, D), bf16)
    ln = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
    qg = q.reshape(B, Hkv, G, D)
    err = 0.0
    for layer in (0, L - 1):
        got = ops.decode_attention(q, kc[layer], vc[layer], ln)
        plain = ref.decode_ref(qg, kc[layer], vc[layer], ln)
        e, ok = within(got.reshape(plain.shape), plain, BF16_TOL)
        check(ok, f"{name} decode shape: kernel vs plain error {e}")
        err = max(err, e)
    out = torch.empty_like(qg)
    scale = 1.0 / math.sqrt(D)

    def run_kernel(layer):
        code = kernel.decode_attention_grouped(qg, kc[layer], vc[layer], ln,
                                               out, scale)
        if code:
            raise RuntimeError(f"CUDA error {code}")

    mask = (torch.arange(S, device=DEVICE)[None, :] < ln[:, None].long()
            )[:, None, None, :]  # [B, 1, 1, S]
    kt = [kc[layer].transpose(1, 2).contiguous() for layer in range(L)]
    vt = [vc[layer].transpose(1, 2).contiguous() for layer in range(L)]
    qs = q.transpose(1, 2).contiguous()  # [B, Hq, 1, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = decode_times(
        torch, L, run_kernel,
        lambda layer: ops.decode_attention(q, kc[layer], vc[layer], ln),
        lambda layer: ref.decode_ref(qg, kc[layer], vc[layer], ln),
        lambda layer: sdpa(qs, kt[layer], vt[layer], attn_mask=mask,
                           enable_gqa=True))
    flops, bytes_moved = kernel_cost.decode_attention(
        q, kc[0], sum(min(n, S) for n in lens))  # the K and V rows attended
    bms, by = bound_ms(bytes_moved, flops, H100_BF16_FLOPS)
    shape = getattr(kernel, "launch_shape", None)  # older trees lack it
    del kc, vc, kt, vt
    torch.cuda.empty_cache()
    return {"config": name, "layers": L, "B": B, "Hkv": Hkv, "G": G, "D": D,
            "S": S, "lens": lens,
            "splits_warps": shape(bf16, B, Hkv, G, D, S) if shape else None,
            **times, "bound_ms": bms, "bound_by": by,
            "bytes": bytes_moved, "flops": flops, "max_err": err,
            "achieved_GBps": bytes_moved / (times["kernel_ms"] * 1e-3) / 1e9}


def phase_decode(torch, ops, ref, kernel):
    """The contiguous decode kernel vs ``ref.decode_ref`` on the card:
    every head dim of ``DECODE_HEADS`` in f32 and bf16; S = 77 and the slot
    engine's max_len; ragged lengths and idle rows
    whose length is past S (the kernel clamps, the plain mask admits
    everything); whisper-small's cross shape (``WHISPER_CROSS``); then its
    times at zamba2's decode shape, at llama3.2-3b's heads, at whisper's
    cross shape and at internvl2-1b's heads (G 7)."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    cases, worst = [], 0.0
    for (label, Hkv, G, D), (dtype, tol) in (
            (heads, types) for heads in DECODE_HEADS
            for types in ((f32, F32_TOL), (bf16, BF16_TOL))):
        name = f"{label}-{str(dtype).split('.')[-1]}"
        for S in (77, STATE_ENGINE["max_len"]):
            lens = [1, 31, 32, 33, S - 1, S, S + 1, S + 500]
            B = len(lens)
            q = card_randn(torch, gen, (B, 1, Hkv * G, D), dtype)
            kc = card_randn(torch, gen, (B, S, Hkv, D), dtype)
            vc = card_randn(torch, gen, (B, S, Hkv, D), dtype)
            ln = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
            out = ops.decode_attention(q, kc, vc, ln)
            plain = ref.decode_ref(q.reshape(B, Hkv, G, D), kc, vc,
                                   ln).reshape(out.shape)
            torch.cuda.synchronize()
            err, ok = within(out, plain, tol)
            check(ok and bool(torch.isfinite(out).all()),
                  f"decode {name} S={S}: kernel vs plain error {err} > "
                  f"{tol[0]} + {tol[1]} x |plain|")
            worst = max(worst, err)
            cases.append({"config": name, "dtype": str(dtype).split(".")[-1],
                          "Hkv": Hkv, "G": G, "D": D, "S": S, "lens": lens,
                          "max_err": err, "atol": tol[0], "rtol": tol[1]})
    B, Hkv, G, D, S = WHISPER_CROSS
    for dtype, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        q = card_randn(torch, gen, (B, 1, Hkv * G, D), dtype)
        kc = card_randn(torch, gen, (B, S, Hkv, D), dtype)
        vc = card_randn(torch, gen, (B, S, Hkv, D), dtype)
        ln = torch.full((B,), S, dtype=torch.int32, device=DEVICE)
        out = ops.decode_attention(q, kc, vc, ln)
        plain = ref.decode_ref(q.reshape(B, Hkv, G, D), kc, vc,
                               ln).reshape(out.shape)
        torch.cuda.synchronize()
        err, ok = within(out, plain, tol)
        name = f"whisper-small-cross-{str(dtype).split('.')[-1]}"
        check(ok, f"decode {name}: kernel vs plain error {err}")
        worst = max(worst, err)
        cases.append({"config": name, "dtype": str(dtype).split(".")[-1],
                      "Hkv": Hkv, "G": G, "D": D, "S": S, "lens": [S] * B,
                      "max_err": err, "atol": tol[0], "rtol": tol[1]})
    rng = np.random.RandomState(4)
    zlens = state_prompt_lens(rng, STATE_ARCHS[1], 16)[:8] + \
        rng.randint(1, 33, size=8)  # prompts and generated tokens
    zamba = decode_timing(torch, ops, ref, kernel, "zamba2-2.7b",
                          ZAMBA_ATTN_LAYERS, 8, 32, 1, 80,
                          STATE_ENGINE["max_len"], zlens)
    llama = decode_timing(torch, ops, ref, kernel, "llama3.2-3b", 28, 8, 8,
                          3, 128, MAIN_PATH_ENGINE["max_len"],
                          rng.randint(480, 545, size=8))
    # whisper-small's cross decode (its 12 decoder layers' caches) and
    # internvl2-1b's self decode (24 layers, G 7) at S 512
    whisper = decode_timing(torch, ops, ref, kernel, "whisper-small-cross",
                            12, B, Hkv, G, D, S, [S] * B)
    internvl = decode_timing(torch, ops, ref, kernel, "internvl2-1b", 24, 8,
                             2, 7, 64, 512, rng.randint(480, 545, size=8))
    extra = {"whisper-small-cross": whisper, "internvl2-1b": internvl}
    worst = max([worst, zamba["max_err"], llama["max_err"]]
                + [t["max_err"] for t in extra.values()])
    return cases, zamba, llama, extra, worst


def wkv_inputs(torch, gen, dtype, B, T, H, hd, s0_scale, strong=False):
    """r, k, v (0.5 x N(0, 1)), lw, u and s0 (None at scale 0): lw =
    -exp(N(0, 1) - 1) as a model's decay; ``strong``: -e^x for x uniform
    in [-3, 3], so a token can decay by e^-20 and the cumulative decay
    reaches the hundreds within a chunk."""
    f32 = torch.float32
    r, k, v = (card_randn(torch, gen, (B, T, H, hd), dtype, 0.5)
               for _ in range(3))
    if strong:
        lw = -torch.exp(6.0 * torch.rand((B, T, H, hd), generator=gen,
                                         device=DEVICE) - 3.0)
    else:
        lw = -torch.exp(card_randn(torch, gen, (B, T, H, hd), f32) - 1.0)
    u = card_randn(torch, gen, (H, hd), f32, 0.1)
    s0 = (card_randn(torch, gen, (B, H, hd, hd), f32, s0_scale)
          if s0_scale else None)
    return r, k, v, lw, u, s0


# phase 4's cases, (B, T, H, hd, chunk, s0 scale): the smoke width with a T
# that is no multiple of the chunk, and the full width; in bf16 besides
# (with a last flag, the strong decay) T 1, 17, 20 and 24 as one chunk,
# T = L, 2L and 3L, s0 absent and set, head_dim 32
WKV_CASES = ((2, 37, 4, 16, 8, 0.1), (1, 200, 32, 64, 32, 0.1),
             WKV_SHAPE + (0.1,))
WKV_BF16_CASES = (
    (1, 1, 32, 64, 32, 0.0, False), (1, 1, 32, 64, 32, 0.1, False),
    (1, 17, 32, 64, 32, 0.1, False), (1, 20, 32, 64, 32, 0.0, False),
    (1, 32, 32, 64, 32, 0.1, False), (1, 64, 32, 64, 32, 0.0, False),
    (1, 96, 32, 64, 32, 0.1, False), WKV_SHAPE + (0.0, False),
    WKV_SHAPE + (0.1, True), (2, 128, 32, 64, 32, 0.1, False),
    (2, 70, 4, 16, 8, 0.0, False), (1, 96, 8, 32, 32, 0.1, True),
    (1, 24, 8, 64, 32, 0.0, False))


def phase_wkv(torch, ops, ref, kernel, sass):
    """The WKV6 kernel vs ``ref.wkv_chunked_ref`` on the card: y and the
    final state for ``WKV_CASES`` in f32 and bf16 and ``WKV_BF16_CASES``;
    at ``WKV_SHAPE`` two calls bit-equal; bf16 shapes the body refuses
    raise with the launch count unchanged; then the times at
    ``WKV_TIMED_SHAPES``.  Fails if the WKV6 library's SASS holds no HMMA
    (tensor-core) instruction."""
    check(sass["HMMA"] > 0, f"wkv6 library has no HMMA instruction: {sass}")
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    runs = [(f32, c + (False,)) for c in WKV_CASES]
    runs += [(bf16, c + (False,)) for c in WKV_CASES]
    runs += [(bf16, c) for c in WKV_BF16_CASES]
    cases, worst = [], 0.0
    for dtype, (B, T, H, hd, chunk, s0_scale, strong) in runs:
        tol = SCAN_F32_TOL if dtype == f32 else BF16_TOL
        r, k, v, lw, u, s0 = wkv_inputs(torch, gen, dtype, B, T, H, hd,
                                        s0_scale, strong)
        before = ops.launches
        y, s = ops.wkv(r, k, v, lw, u, chunk=chunk, s0=s0)
        L = min(chunk, T)
        pad = -T % L
        padded = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                  for t in (r, k, v, lw)]
        py, ps = ref.wkv_chunked_ref(*padded, u, L, s0)
        torch.cuda.synchronize()
        err, ok = within(y, py[:, :T], tol)
        serr, sok = within(s, ps, SCAN_F32_TOL)
        name = f"wkv {dtype} {(B, T, H, hd, chunk, s0_scale, strong)}"
        check(ops.launches == before + 1, f"{name}: not one launch")
        check(ok and sok and bool(torch.isfinite(y).all())
              and bool(torch.isfinite(s).all()),
              f"{name}: y error {err}, state error {serr}")
        worst = max(worst, err, serr)
        cases.append({"dtype": str(dtype).split(".")[-1], "B": B, "T": T,
                      "H": H, "hd": hd, "chunk": L, "s0": s0_scale,
                      "strong_decay": strong, "max_err": err,
                      "state_err": serr, "atol": tol[0], "rtol": tol[1]})
    # two wrapper calls bit-equal at the prefill shape
    B, T, H, hd, L = WKV_SHAPE
    r, k, v, lw, u, s0 = wkv_inputs(torch, gen, bf16, B, T, H, hd, 0.1)
    y1, s1 = ops.wkv(r, k, v, lw, u, chunk=L, s0=s0)
    y2, s2 = ops.wkv(r, k, v, lw, u, chunk=L, s0=s0)
    torch.cuda.synchronize()
    check(torch.equal(y1, y2) and torch.equal(s1, s2),
          "wkv: two calls on the same inputs differ")
    # bf16 shapes the body refuses: head_dim not 16, 32 or 64, a chunk over
    # 32, r not on a 16-byte boundary
    refused = []
    for hd_, chunk_, shift in ((24, 8, 0), (48, 8, 0), (128, 8, 0),
                               (64, 64, 0), (64, 32, 1)):
        r, k, v, lw, u, _ = wkv_inputs(torch, gen, bf16, 1, 128, 2, hd_, 0.0)
        if shift:  # a contiguous view one element past an aligned start
            flat = torch.empty(r.numel() + shift, dtype=bf16, device=DEVICE)
            r = flat[shift:].view(r.shape).copy_(r)
        before = ops.launches
        try:
            ops.wkv(r, k, v, lw, u, chunk=chunk_)
        except ValueError as e:
            refused.append({"hd": hd_, "chunk": chunk_, "shift": shift,
                            "error": str(e)})
        else:
            check(False, f"wkv bf16 hd {hd_} chunk {chunk_} shift {shift}: "
                         "launched, not refused")
        check(ops.launches == before,
              f"wkv bf16 hd {hd_} chunk {chunk_}: counted")
    timings = [wkv_timing(torch, ops, ref, kernel, gen, shape)
               for shape in WKV_TIMED_SHAPES]
    return cases, refused, timings, worst


def scan_times(torch, layers, kernel, wrapper, plain):
    """Per-call times of a scan kernel over ``layers`` input sets, one a
    layer as a prefill holds them (so at a real prefill shape each call's
    inputs are cold in the 50 MB L2), each argument a function of the
    layer: the raw kernel eagerly (``kernel_ms``, and again at the end) and
    replayed from a CUDA graph of the layer loop (``graph_ms``: device time
    without host dispatch); the host's time to issue the wrapper the model
    calls (``host_ms``); the plain version on one layer."""
    def loop(fn):
        return lambda: [fn(layer) for layer in range(layers)]

    t = {"kernel_ms": cuda_ms(loop(kernel), 20) / layers}
    t["plain_ms"] = cuda_ms(lambda: plain(0), 5)
    t["graph_ms"] = graph_ms(torch, loop(kernel), 10) / layers
    t["host_ms"] = host_ms(torch, loop(wrapper), 5) / layers
    t["kernel_ms_repeat"] = cuda_ms(loop(kernel), 20) / layers
    return t


WKV_LAYERS = 24  # rwkv6-1.6b
# rwkv6-1.6b's WKV6 prefill shapes, bf16 (B, T, H, hd, chunk): a 256-token
# prompt (eight chunks) and a short prompt of 20 tokens (one chunk of 20,
# the log-normal prompts' median)
WKV_TIMED_SHAPES = (WKV_SHAPE, (1, 20, 32, 64, 20))


def wkv_timing(torch, ops, ref, kernel, gen, shape=WKV_SHAPE):
    """The WKV6 kernel at an rwkv6-1.6b prefill shape (``WKV_SHAPE`` by
    default: bf16 r/k/v, float32 decay, zero initial state) over its 24
    layers' input sets (at ``WKV_SHAPE`` 24 x 6.3 MB, cold in L2 each
    call), held against the plain version on the first and last layer,
    then timed beside it and the bound; no PyTorch call computes WKV6."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, T, H, hd, L = shape
    n_l = WKV_LAYERS
    r, k, v = (card_randn(torch, gen, (n_l, B, T, H, hd), bf16, 0.5)
               for _ in range(3))
    lw = -torch.exp(card_randn(torch, gen, (n_l, B, T, H, hd), f32) - 1.0)
    u = card_randn(torch, gen, (H, hd), f32, 0.1)
    s0 = torch.zeros((B, H, hd, hd), dtype=f32, device=DEVICE)
    y = torch.empty_like(r)
    s = torch.empty((n_l, B, H, hd, hd), dtype=f32, device=DEVICE)
    # each layer's views, made once so a timed call issues only the launch
    ins = list(zip(r, k, v, lw))
    outs = list(zip(y, s))

    def run_kernel(i):
        code = kernel.wkv6_forward(*ins[i], u, s0, *outs[i], L)
        if code:
            raise RuntimeError(f"CUDA error {code}")

    err = serr = 0.0
    for i in (0, n_l - 1):
        run_kernel(i)
        py, ps = ref.wkv_chunked_ref(*ins[i], u, L, s0)
        torch.cuda.synchronize()
        e, ok = within(y[i], py, BF16_TOL)
        se, sok = within(s[i], ps, SCAN_F32_TOL)
        check(ok and sok, f"wkv timing shape {shape} layer {i}: y error "
                          f"{e}, state error {se}")
        err, serr = max(err, e), max(serr, se)
    times = scan_times(
        torch, n_l, run_kernel,
        lambda i: ops.wkv(*ins[i], u, chunk=L, s0=s0),
        lambda i: ref.wkv_chunked_ref(*ins[i], u, L, s0))
    ops_count, bytes_moved = kernel_cost.wkv(r[0], L, has_s0=True)
    bms, by = bound_ms(bytes_moved, ops_count, H100_BF16_FLOPS)
    del r, k, v, lw, y, s, ins, outs
    torch.cuda.empty_cache()
    return {"config": "rwkv6-1.6b", "B": B, "T": T, "H": H, "hd": hd,
            "chunk": L, "dtype": "bfloat16", "layers": n_l, **times,
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "bytes": bytes_moved, "operations": ops_count, "max_err": err,
            "state_err": serr}


def ssd_inputs(torch, gen, dtype, B, T, H, P, N, h0_scale):
    """x, dt, A, B, C and h0 (None at scale 0) as the model makes them:
    dt = softplus(. - 2), A in -[1, 16]."""
    f32 = torch.float32
    x = card_randn(torch, gen, (B, T, H, P), dtype)
    dt = torch.nn.functional.softplus(
        card_randn(torch, gen, (B, T, H), f32) - 2.0)
    A = -(1.0 + 15.0 * torch.rand((H,), generator=gen, device=DEVICE))
    Bm = card_randn(torch, gen, (B, T, N), dtype)
    Cm = card_randn(torch, gen, (B, T, N), dtype)
    h0 = (card_randn(torch, gen, (B, H, N, P), f32, h0_scale)
          if h0_scale else None)
    return x, dt, A, Bm, Cm, h0


# zamba2-2.7b's SSD prefill shapes, bf16 (B, T, H, P, N, L): a 384-token
# prompt (three chunks), one full chunk, and a short prompt of 20 tokens
# (one chunk of 20, the log-normal prompts' median)
SSD_TIMED_SHAPES = (SSD_SHAPE, (1, 128, 80, 64, 64, 128),
                    (1, 20, 80, 64, 64, 20))
SSD_LAYERS = 54  # zamba2-2.7b's mamba layers


def ssd_timing(torch, ops, ref, kernel, gen, shape):
    """The SSD kernel at ``shape`` in bf16 (no initial state) over
    zamba2-2.7b's 54 layers' input sets (at ``SSD_SHAPE`` 54 x 9.4 MB, cold
    in L2 each call), held against the plain version on the first and last
    layer, then timed beside it and the bound; no PyTorch call computes
    it."""
    B, T, H, P, N, L = shape
    n_l = SSD_LAYERS
    x, dt, A, Bm, Cm, _ = ssd_inputs(torch, gen, torch.bfloat16, n_l * B, T,
                                     H, P, N, 0.0)
    x, dt, Bm, Cm = (t.view(n_l, B, *t.shape[1:]) for t in (x, dt, Bm, Cm))
    y = torch.empty_like(x)
    h = torch.empty((n_l, B, H, N, P), dtype=torch.float32, device=DEVICE)
    # each layer's views, made once so a timed call issues only the launch
    ins = [(xi, di, A, bi, ci) for xi, di, bi, ci in zip(x, dt, Bm, Cm)]
    outs = list(zip(y, h))

    def run_kernel(i):
        code = kernel.ssd_forward(*ins[i], None, *outs[i], L)
        if code:
            raise RuntimeError(f"CUDA error {code}")

    err = serr = 0.0
    for i in (0, n_l - 1):
        run_kernel(i)
        py, ph = ref.ssd_chunked_ref(*ins[i], L)
        torch.cuda.synchronize()
        e, ok = within(y[i], py, BF16_TOL)
        se, sok = within(h[i], ph, SCAN_F32_TOL)
        check(ok and sok, f"ssd timing shape {shape} layer {i}: y error "
                          f"{e}, state error {se}")
        err, serr = max(err, e), max(serr, se)
    times = scan_times(torch, n_l, run_kernel,
                       lambda i: ops.ssd(*ins[i], chunk=L),
                       lambda i: ref.ssd_chunked_ref(*ins[i], L))
    ops_count, bytes_moved = kernel_cost.ssd(x[0], Bm[0], L, has_h0=False)
    bms, by = bound_ms(bytes_moved, ops_count, H100_BF16_FLOPS)
    del x, dt, Bm, Cm, y, h, ins, outs
    torch.cuda.empty_cache()
    return {"config": "zamba2-2.7b", "B": B, "T": T, "H": H, "P": P, "N": N,
            "chunk": L, "dtype": "bfloat16", "layers": n_l, **times,
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "bytes": bytes_moved, "operations": ops_count, "max_err": err,
            "state_err": serr}


# phase 5's cases, (B, T, H, P, N, chunk, h0 scale): the smoke and full
# widths, a 37-token prompt as one chunk of 37; in bf16 besides T 1, 17 and
# 37 as one chunk, T = L, 2L and 3L at L 128, with and without h0, and
# every template of the bf16 body (P 16, 32 and 64, each with N up to 64
# and up to 128)
SSD_CASES = ((2, 96, 4, 16, 16, 16, 0.1), (1, 37, 4, 16, 16, 128, 0.1),
             SSD_SHAPE + (0.1,))
SSD_BF16_CASES = (
    (1, 1, 80, 64, 64, 128, 0.0), (1, 1, 80, 64, 64, 128, 0.1),
    (1, 17, 80, 64, 64, 128, 0.0), (1, 37, 80, 64, 64, 128, 0.1),
    (1, 128, 80, 64, 64, 128, 0.0), (1, 256, 80, 64, 64, 128, 0.1),
    SSD_SHAPE + (0.0,), (2, 128, 80, 64, 64, 128, 0.1),
    (1, 200, 4, 64, 64, 40, 0.1), (2, 64, 8, 16, 16, 16, 0.0),
    (1, 256, 8, 32, 32, 128, 0.1), (1, 128, 33, 16, 96, 128, 0.0),
    (2, 128, 40, 32, 128, 128, 0.1), (1, 256, 8, 64, 128, 128, 0.0))


def phase_ssd(torch, ops, ref, kernel, sass):
    """The SSD kernel vs ``ref.ssd_chunked_ref`` on the card: y and the
    final state for ``SSD_CASES`` in f32 and bf16 and ``SSD_BF16_CASES``;
    at ``SSD_SHAPE`` two calls bit-equal; bf16 shapes the body refuses
    raise with the launch count unchanged; then the times at
    ``SSD_TIMED_SHAPES``.  Fails if the SSD library's SASS holds no HMMA
    (tensor-core) instruction."""
    check(sass["HMMA"] > 0, f"ssd library has no HMMA instruction: {sass}")
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    cases, worst = [], 0.0
    runs = [(f32, c) for c in SSD_CASES] + [(bf16, c) for c in SSD_CASES]
    runs += [(bf16, c) for c in SSD_BF16_CASES]
    for dtype, (B, T, H, P, N, chunk, h0_scale) in runs:
        tol = SCAN_F32_TOL if dtype == f32 else BF16_TOL
        x, dt, A, Bm, Cm, h0 = ssd_inputs(torch, gen, dtype, B, T, H, P, N,
                                          h0_scale)
        before = ops.launches
        y, h = ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        L = min(chunk, T)
        py, ph = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, L, h0)
        torch.cuda.synchronize()
        err, ok = within(y, py, tol)
        serr, sok = within(h, ph, SCAN_F32_TOL)
        name = f"ssd {dtype} {(B, T, H, P, N, chunk, h0_scale)}"
        check(ops.launches == before + 1, f"{name}: not one launch")
        check(ok and sok and bool(torch.isfinite(y).all()),
              f"{name}: y error {err}, state error {serr}")
        worst = max(worst, err, serr)
        cases.append({"dtype": str(dtype).split(".")[-1], "B": B, "T": T,
                      "H": H, "P": P, "N": N, "chunk": L, "h0": h0_scale,
                      "max_err": err, "state_err": serr, "atol": tol[0],
                      "rtol": tol[1]})
    # two wrapper calls bit-equal at the prefill shape
    B, T, H, P, N, L = SSD_SHAPE
    x, dt, A, Bm, Cm, h0 = ssd_inputs(torch, gen, bf16, B, T, H, P, N, 0.1)
    y1, h1 = ops.ssd(x, dt, A, Bm, Cm, chunk=L, h0=h0)
    y2, h2 = ops.ssd(x, dt, A, Bm, Cm, chunk=L, h0=h0)
    torch.cuda.synchronize()
    check(torch.equal(y1, y2) and torch.equal(h1, h2),
          "ssd: two calls on the same inputs differ")
    # bf16 shapes the body refuses: N not a multiple of 16 or over 128, P
    # not 16, 32 or 64
    refused = []
    for P_, N_ in ((64, 24), (24, 64), (64, 144), (128, 64), (48, 64)):
        xr, dtr, Ar, Br, Cr, _ = ssd_inputs(torch, gen, bf16, 1, 16, 2, P_,
                                            N_, 0.0)
        before = ops.launches
        try:
            ops.ssd(xr, dtr, Ar, Br, Cr, chunk=16)
        except ValueError as e:
            refused.append({"P": P_, "N": N_, "error": str(e)})
        else:
            check(False, f"ssd bf16 P {P_} N {N_}: launched, not refused")
        check(ops.launches == before, f"ssd bf16 P {P_} N {N_}: counted")
    timings = [ssd_timing(torch, ops, ref, kernel, gen, shape)
               for shape in SSD_TIMED_SHAPES]
    return cases, refused, timings, worst


def oracle_logits(torch, get_model, cfg, params, tokens):
    """Last-position logits of a forward over ``tokens`` that launches no
    kernel: rwkv6 through ``wkv_recurrent`` (``chunked=False``), zamba2
    through ``mamba_block_apply(recurrent_oracle=True)`` and the shared
    block's prefill (PyTorch attention), dense through its prefill (the
    same)."""
    from repro_torch.models import mamba2, nn, rwkv6
    from repro_torch.models import transformer as tfm

    t = torch.tensor([tokens], device=DEVICE)
    if cfg.family == "ssm":
        x = nn.layernorm_apply(params["ln_in"], nn.embedding_apply(
            params["embed"], t, cfg.cdtype), cfg.norm_eps)
        for bp in params["blocks"]:
            x, _ = rwkv6.rwkv_block_apply(bp, x, cfg, chunked=False)
        x = nn.layernorm_apply(params["ln_f"], x[:, -1:], cfg.norm_eps)
    elif cfg.family == "hybrid":
        x = nn.embedding_apply(params["embed"], t, cfg.cdtype)
        pos = torch.arange(len(tokens), device=DEVICE)[None, :]
        for group in params["groups"]:
            for bp in group:
                x = mamba2.mamba_block_apply(bp, x, cfg,
                                             recurrent_oracle=True)
            x, _ = tfm.block_prefill(params["shared"], x, cfg,
                                     max_len=len(tokens), positions=pos)
        x = nn.rmsnorm_apply(params["ln_f"], x[:, -1:], cfg.norm_eps)
    else:
        _, logits = get_model(cfg).prefill(params, {"tokens": t}, cfg,
                                           max_len=len(tokens))
        return logits[0]
    return nn.linear_apply(params["unembed"], x, torch.float32)[0, 0]


def teacher_forced(torch, get_model, cfg, params, prompts, outs, where,
                   memo=None, gap_tol=MODEL_GAP_TOL):
    """Every token of each transcript against the kernel-free oracle's
    argmax on the transcript so far (``oracle_logits``): a token may
    differ only where the oracle's top-two gap is under ``gap_tol``.
    Checks that the oracle launched no kernel; -> the flips.  ``memo``
    keeps the oracle's logits between calls on one model."""
    memo = {} if memo is None else memo
    zero_launches()
    flips = []
    for p, out in zip(prompts, outs):
        for i, tok in enumerate(out):
            key = tuple(p + out[:i])
            if key not in memo:
                memo[key] = oracle_logits(torch, get_model, cfg, params,
                                          list(key))
            logits = memo[key]
            best = int(logits.argmax())
            if tok != best:
                gap = float(logits[best] - logits[tok])
                check(gap < gap_tol,
                      f"{where}: engine token {tok} != oracle {best} at "
                      f"step {i} of a {len(p)}-token prompt, gap {gap}")
                flips.append({"prompt_len": len(p), "step": i, "gap": gap})
    check_launches(f"{where} oracle")  # the oracle ran no kernel
    return flips


def phase_state_model(torch, configs, get_model, engine_mod):
    """f32 on the card: rwkv6-1.6b (2 layers) and zamba2-2.7b (2 groups),
    full width, and rhapsody-demo, through the slot engine (paged=False):
    its greedy transcripts against a recurrent oracle on the same card that
    runs no kernel, teacher-forced on the engine's transcript (a token may
    differ only where the oracle's top-two gap is under MODEL_GAP_TOL)."""
    records = []
    for arch, cut, lens in (
            ("rwkv6-1.6b", {"n_layers": 2}, (3, 17, 40, 100)),
            ("zamba2-2.7b", {"n_layers": 12}, (3, 17, 64, 128, 256)),
            ("rhapsody-demo", {}, (3, 8, 9, 17, 30))):
        cfg = configs.get_config(arch).scaled(
            param_dtype="float32", compute_dtype="float32", **cut)
        api = get_model(cfg)
        params = api.init(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                          device=DEVICE)
        rng = np.random.RandomState(len(lens))
        prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
                   for n in lens]
        steps = 6
        eng = engine_mod.InferenceEngine(
            cfg, params, device=DEVICE, paged=False, max_num_seqs=4,
            max_num_batched_tokens=512, max_len=320,
            prefill_buckets=(16, 32, 64))
        zero_launches()
        uids = [eng.submit(p, max_new_tokens=steps) for p in prompts]
        done = eng.run()
        torch.cuda.synchronize()
        if cfg.family == "ssm":
            want = {"wkv6": cfg.n_layers * len(prompts)}
        elif cfg.family == "hybrid":
            want = {"ssd": cfg.n_layers * len(prompts),
                    "decode_attention": (cfg.n_layers // cfg.attn_every)
                    * eng.stats.decode_steps}
        else:
            want = {"decode_attention": cfg.n_layers * eng.stats.decode_steps}
        launches = check_launches(f"model {arch}", **want)
        check(eng.stats.decode_steps > 0, f"model {arch}: no decode step")
        outs = [done[u].output for u in uids]
        flips = teacher_forced(torch, get_model, cfg, params, prompts, outs,
                               f"model {arch}")
        records.append({"config": arch, "cut": cut, "prompt_lens": lens,
                        "new_tokens": steps, "transcripts_equal": not flips,
                        "teacher_forced_flips": flips, "launches": launches,
                        "decode_steps": eng.stats.decode_steps})
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    return records


def phase_hybrid_forward(torch, configs, get_model):
    """zamba2-2.7b's ``forward`` (the training forward: the SSD kernel in
    every Mamba2 layer, the flash kernel at head_dim 80 in every shared
    block) on one prompt on the card, random weights from seed 0.  In f32
    cut to 12 layers, its last-position logits against ``oracle_logits``
    (no kernel) within ``HYBRID_F32_TOL``; in bf16 at the full 54 layers,
    finite logits; timed cold and three times warm (the median kept)."""
    records = []
    for dtype, cut, T in (("float32", {"n_layers": 12}, 256),
                          ("bfloat16", {}, 384)):
        cfg = configs.get_config("zamba2-2.7b").scaled(
            param_dtype=dtype, compute_dtype=dtype, **cut)
        api = get_model(cfg)
        params = api.init(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                          device=DEVICE)
        tokens = [int(t) for t in
                  np.random.RandomState(T).randint(1, cfg.vocab, size=T)]
        batch = {"tokens": torch.tensor([tokens], device=DEVICE)}
        want = {"ssd": cfg.n_layers,
                "flash_attention": cfg.n_layers // cfg.attn_every}
        seconds = []
        for _ in range(4):  # cold, then three warm
            zero_launches()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, _ = api.forward(params, batch, cfg)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            launches = check_launches(f"zamba2 forward {dtype}", **want)
        check(tuple(logits.shape) == (1, T, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"zamba2 forward {dtype}: logits not finite or misshapen")
        rec = {"config": cfg.name, "dtype": dtype, "layers": cfg.n_layers,
               "T": T, "launches": launches, "seconds_cold": seconds[0],
               "seconds_warm": sorted(seconds[1:])[1],
               "seconds_warm_runs": seconds[1:]}
        if dtype == "float32":
            zero_launches()
            with torch.no_grad():
                oracle = oracle_logits(torch, get_model, cfg, params, tokens)
            check_launches("zamba2 forward oracle")  # it ran no kernel
            err, ok = within(logits[0, -1], oracle, HYBRID_F32_TOL)
            check(ok, f"zamba2 forward f32: logits vs oracle error {err} > "
                      f"{HYBRID_F32_TOL[0]} + {HYBRID_F32_TOL[1]} x |oracle|")
            rec.update(max_err=err, atol=HYBRID_F32_TOL[0],
                       rtol=HYBRID_F32_TOL[1])
        records.append(rec)
        del params, logits
        gc.collect()
        torch.cuda.empty_cache()
    return records


def phase_state_serving(torch, configs, core, client, arch,
                        engine=STATE_ENGINE):
    """rwkv6-1.6b or zamba2-2.7b (phases 10-11), or whisper-small or
    internvl2-1b (phase 28, log-normal prompts as phase 8's) at full width
    (bf16, random weights from seed 0) behind ``Rhapsody`` with 2
    replicas through the default ``LLMServicer`` (auto: the slot pool): 16
    requests of 32 new tokens, served twice (cold, then warm) with prompts
    of the same lengths."""
    cfg = configs.get_config(arch)
    replicas, n_req, mnt = 2, 16, MAIN_PATH_NEW_TOKENS
    rh = core.Rhapsody(core.ResourceDescription(nodes=replicas,
                                                cores_per_node=16),
                       n_workers=2)
    try:
        t_up = time.perf_counter()
        rs = rh.add_service(core.ServiceDescription(
            name="llm", replicas=replicas, ready_timeout=600,
            factory=client.llm_service_factory(cfg, device=DEVICE,
                                               **engine)))
        setup_s = time.perf_counter() - t_up
        check(all(not inst.servicer.engine.paged for inst in rs.instances),
              f"{arch}: the servicer did not resolve to the slot pool")
        first = list(rs.instances)  # a crashed replica is relaunched
        rng = np.random.RandomState(1)
        if arch in STATE_ARCHS:
            lens = state_prompt_lens(rng, arch, n_req)
        else:
            lens = np.clip(np.exp(rng.normal(3.0, 0.7, n_req)), 4,
                           engine["max_len"] - mnt - 1).astype(int)

        def serve_pass():
            prompts = [list(map(int, rng.randint(0, cfg.vocab, size=int(n))))
                       for n in lens]
            descs = [core.TaskDescription(
                kind=core.TaskKind.INFERENCE, service="llm",
                payload={"prompt": p, "max_new_tokens": mnt},
                task_type="inference") for p in prompts]
            t0 = time.perf_counter()
            uids = rh.submit(descs)
            check(rh.wait(uids, timeout=600), f"{arch}: serving timed out")
            results = [rh.result(u) for u in uids]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(all(r is not None and len(r["tokens"]) == mnt
                      and all(0 <= t < cfg.vocab for t in r["tokens"])
                      for r in results),
                  f"{arch}: a request came back short or out of the "
                  f"vocabulary")
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
        zero_launches()
        prompts, cold = serve_pass()
        _, warm = serve_pass()
        errors = ["".join(traceback.format_exception(inst.error))
                  for inst in first + rs.instances if inst.error is not None]
        check(not errors and rs.instances == first,
              f"{arch}: a replica crashed and was relaunched "
              f"(its in-flight requests replayed): {errors}")
        decode_steps = sum(inst.servicer.stats.decode_steps
                           for inst in rs.instances)
        prefills = 2 * n_req  # exact-length prefills: no prefix reuse here
        if cfg.family == "ssm":
            want = {"wkv6": cfg.n_layers * prefills}
        elif cfg.family == "hybrid":
            want = {"ssd": cfg.n_layers * prefills,
                    "decode_attention": (cfg.n_layers // cfg.attn_every)
                    * decode_steps}
        else:
            want = {"decode_attention": decode_per_step(cfg) * decode_steps}
        launches = check_launches(arch, **want)
        check(decode_steps > 0, f"{arch}: no decode step ran")
        peak = torch.cuda.max_memory_allocated() / 1e9
        stats = rs.stats()
        eng = rs.instances[0].servicer.engine
        _, logits = eng.api.prefill(
            eng.params, stub_batch(torch, cfg, [prompts[0]]), cfg,
            max_len=eng.max_len + cfg.vision_tokens)
        check(tuple(logits.shape) == (1, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"{arch}: prefill logits not finite")
        return {"config": cfg.name, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "vocab": cfg.vocab,
                "dtype": cfg.compute_dtype, "replicas": replicas,
                "engine": engine, "requests_per_pass": n_req,
                "max_new_tokens": mnt,
                "prompt_lens": [int(x) for x in lens],
                "setup_seconds": setup_s, "cold": cold, "warm": warm,
                "launches": launches, "decode_steps": decode_steps,
                "prefills": prefills,
                "per_replica_requests": [p["requests"]
                                         for p in stats["per_replica"]],
                "peak_mem_gb": peak}
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
    err, ok = within(out.detach(), plain, tol)
    lse_err = float((lse - plain_lse).abs().max())
    check(ok, f"flash {name} S={S}: out error {err} > {atol} + {rtol} x "
              f"|plain|")
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
    """Flash kernel vs plain on the card: out, lse and the gradient, for
    each body and head_dim on a path (D 32 f32; D 80, 128 and internvl2-1b's
    D 64 at seven query heads a group, f32 and bf16) at every length of
    ``FLASH_SEQS``."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for name, dtype, Hq, Hkv, D, tol, gtol in (
            ("rhapsody-demo", f32, 8, 4, 32, F32_TOL, F32_GRAD_TOL),
            ("zamba2-2.7b-f32", f32, 32, 32, 80, F32_TOL, F32_GRAD_TOL),
            ("zamba2-2.7b", bf16, 32, 32, 80, BF16_TOL, BF16_GRAD_TOL),
            ("llama3.2-3b-f32", f32, 24, 8, 128, F32_TOL, F32_GRAD_TOL),
            ("llama3.2-3b", bf16, 24, 8, 128, BF16_TOL, BF16_GRAD_TOL),
            ("internvl2-1b-f32", f32, 14, 2, 64, F32_TOL, F32_GRAD_TOL),
            ("internvl2-1b", bf16, 14, 2, 64, BF16_TOL, BF16_GRAD_TOL)):
        for S in FLASH_SEQS:
            cases.append(flash_case(torch, fa, fa_ref, name, dtype, 2, S,
                                    Hq, Hkv, D, tol, gtol)[0])
        gc.collect()
        torch.cuda.empty_cache()
    return cases, max(c["max_err"] for c in cases)


def flash_times(torch, fa_kernel, fa_ref, q, k, v, out, lse):
    """The raw kernel's time on (q, k, v), eager and replayed from a CUDA
    graph, beside the plain version's, the library yardstick's (SDPA,
    causal, GQA; never called by the port; eager and from a graph) and the
    bound."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
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

    kernel_ms = cuda_ms(run_kernel, 20)
    plain_ms = cuda_ms(lambda: fa_ref.attention_fwd_ref(q, k, v), 3)
    library_ms = cuda_ms(run_library, 20)
    graph = graph_ms(torch, run_kernel, 20)
    library_graph = graph_ms(torch, run_library, 20)
    kernel_ms_2 = cuda_ms(run_kernel, 20)
    flops, bytes_moved = kernel_cost.flash_attention(q, k, v)
    bms, by = bound_ms(bytes_moved, flops, H100_BF16_FLOPS)
    return {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
            "dtype": str(q.dtype).split(".")[-1], "kernel_ms": kernel_ms,
            "kernel_ms_repeat": kernel_ms_2, "graph_ms": graph,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_graph_ms": library_graph, "bound_ms": bms,
            "bound_by": by,
            "bytes": bytes_moved, "flops": flops,
            "achieved_TFLOPs": flops / (kernel_ms * 1e-3) / 1e12,
            "percent_of_bound": 100 * bms / kernel_ms}


def phase_flash_timing(torch, fa_kernel, fa, fa_ref, sass):
    """The flash kernel at the llama3.2-3b training shape, at zamba2's
    (B 1, S 384, Hq = Hkv = 32, D 80), and at the decoder self-attention
    of phase 29's training steps (internvl2-1b: B 2, S 256 + 2048, Hq 14,
    Hkv 2, D 64; whisper-small: B 2, S 448, Hq = Hkv = 12, D 64): the
    wrapper and its gradient held against the plain version there, then
    the raw kernel's times (and the plain backward's at the llama3.2-3b
    training shape).  Fails unless the library's
    SASS holds wgmma (HGMMA) and TMA loads (UTMALDG)."""
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          f"flash library SASS has no wgmma or no TMA load: {sass}")
    records = {}
    for name, B, S, Hq, Hkv, D in (
            ("llama3.2-3b", TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128),
            ("zamba2-2.7b", 1, 384, 32, 32, 80),
            ("internvl2-1b", TRAIN_BATCH, VISION_TOKENS + TRAIN_SEQ, 14, 2,
             64),
            ("whisper-small", TRAIN_BATCH, WHISPER_TEXT_CTX, 12, 12, 64)):
        case, (q, k, v, out, lse) = flash_case(
            torch, fa, fa_ref, name, torch.bfloat16, B, S, Hq, Hkv, D,
            BF16_TOL, BF16_GRAD_TOL)
        gc.collect()
        torch.cuda.empty_cache()
        rec = {"config": name, **flash_times(torch, fa_kernel, fa_ref, q, k,
                                             v, out, lse),
               "max_err": case["max_err"], "lse_err": case["lse_err"],
               "grad_err": case["grad_err"]}
        if name == "llama3.2-3b":
            dout = torch.randn(out.shape, device=DEVICE).to(out.dtype)
            rec["attention_bwd_ms"] = cuda_ms(
                lambda: fa_ref.attention_bwd(q, k, v, out, lse, dout), 3)
        records[name] = rec
        del q, k, v, out, lse
        gc.collect()
        torch.cuda.empty_cache()
    return records


def phase_train_step(torch, configs, get_model, optim, train, data):
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
    cpu, _ = train.init_state(torch.Generator().manual_seed(0), api, cfg, opt,
                              device="cpu")
    card = {"params": optim.tree_map(
        lambda t: t.detach().to(DEVICE, copy=True).requires_grad_(),
        cpu["params"])}
    card["opt"] = optim.adamw_init(card["params"], opt)
    batch = data.DataPipeline(data.DataConfig(vocab=cfg.vocab),
                              device="cpu").next_batch()
    step = train.make_train_step(api, cfg, tcfg)
    _, m_cpu = step(cpu, batch)
    zero_launches()
    _, m_card = step(card, {k: v.to(DEVICE) for k, v in batch.items()})
    torch.cuda.synchronize()
    one_step = check_launches("train step",
                              flash_attention=2 * cfg.n_layers)[
        "flash_attention"]
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
    state, _ = train.init_state(torch.Generator(device=DEVICE).manual_seed(0),
                                api, cfg, tcfg.optimizer, device=DEVICE)
    with torch.no_grad():
        held_before = float(api.loss(state["params"], held, cfg)[0])
    zero_launches()
    t0 = time.perf_counter()
    state, hist = train.train_loop(api, cfg, tcfg, steps=30,
                                   data_iter=iter(pipe), state=state,
                                   log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = check_launches("30 steps",
                              flash_attention=2 * cfg.n_layers * 30)[
        "flash_attention"]
    losses = [h["loss"] for h in hist]
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


def phase_train_launcher(launch_train, configs):
    """The trainer launcher with its defaults except --steps 20, then
    ``--arch llama3.2-3b --steps 5`` (its smoke config, head_dim 8),
    ``--arch deepseek-moe-16b --steps 3`` (MoE forward and loss), and
    ``--arch rwkv6-1.6b`` and ``--arch zamba2-2.7b`` with ``--steps 3``
    (the scans' autograd Functions)."""
    runs = []
    for arch, steps in (("rhapsody-demo", 20), ("llama3.2-3b", 5),
                        ("deepseek-moe-16b", 3), ("rwkv6-1.6b", 3),
                        ("zamba2-2.7b", 3)):
        argv = (([] if arch == "rhapsody-demo" else ["--arch", arch])
                + ["--steps", str(steps)])
        cfg = (configs.get_config(arch) if arch == "rhapsody-demo"
               else configs.get_smoke_config(arch))
        zero_launches()
        out = launch_train.main(argv + ([] if DEVICE == "cuda" else
                                        ["--device", DEVICE]))
        where = f"trainer launcher {' '.join(argv)}"
        launches = check_launches(where,
                                  **expected_train_launches(cfg, steps))
        losses = out["losses"]
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"{where}: losses {losses}")
        runs.append({"argv": argv, "head_dim": cfg.head_dim,
                     "losses": losses, "launches": launches,
                     "seconds": out["seconds"], "device": out["device"]})
    return runs


def train_main_path():
    """The training main path (phase 16; profile_train.py builds it here
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
    tcfg = train_tcfg(TRAIN_SEQ)
    pipe = data.DataPipeline(data.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH),
        device=DEVICE)
    state, _ = train.init_state(torch.Generator(device=DEVICE).manual_seed(0),
                                api, cfg, tcfg.optimizer, device=DEVICE)
    return cfg, api, tcfg, pipe, state, train.make_train_step(api, cfg, tcfg)


def phase_train_main_path(torch, optim):
    """llama3.2-3b at full width: DataPipeline -> init_state ->
    make_train_step, global batch 2, seq 2048, 3 AdamW steps."""
    t_up = time.perf_counter()
    cfg, _, _, pipe, state, step = train_main_path()
    n_params = sum(p.numel() for p in optim.tree_leaves(state["params"]))
    state_bytes = tree_bytes(state)  # parameters and AdamW
    watch = [state["params"]["blocks"][0]["attn"]["q"]["w"],
             state["params"]["blocks"][-1]["mlp"]["down"]["w"],
             state["params"]["unembed"]["w"]]
    before = [w.detach()[:64].clone() for w in watch]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_up
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    times, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        batch = pipe.next_batch()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = check_launches(
        "training main path",
        flash_attention=2 * cfg.n_layers * TRAIN_STEPS)["flash_attention"]
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
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "state_bytes": state_bytes}


# ---------------------------------------------------------------------------
# The MoE family (deepseek-moe-16b) and speculative decoding (phases 17-20)
# ---------------------------------------------------------------------------


def moe_overflow(torch, moe, cfg, params):
    """``moe_apply`` on the MoE layer at a 512-token prefill chunk with
    capacity factor 1.0 on the training path (``decode=False``), so that
    tokens are dropped: two card calls bit-equal, and within MOE_CPU_TOL
    of the same function on the CPU (the same drop set)."""
    from repro_torch.training.optim import tree_map

    ocfg = cfg.scaled(capacity_factor=1.0)
    p = params["blocks"][cfg.first_dense_layers]["moe"]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    x = torch.randn((1, MOE_OVERFLOW_T, cfg.d_model), generator=gen,
                    device=DEVICE)
    zero_launches()
    y, aux = moe.moe_apply(p, x, ocfg, decode=False)
    y2, aux2 = moe.moe_apply(p, x, ocfg, decode=False)
    torch.cuda.synchronize()
    check_launches("moe overflow")
    check(torch.equal(y, y2) and torch.equal(aux, aux2),
          "moe overflow: two card calls differ")
    C = moe._capacity(MOE_OVERFLOW_T, ocfg, False)
    _, ids, _ = moe.route(p["router"]["w"], x[0], ocfg)
    counts = moe._counts(ids, cfg.n_experts)
    dropped = int((counts - C).clamp(min=0).sum())
    check(dropped > 0, f"moe overflow: no assignment past capacity {C}")
    cpu_p = tree_map(lambda t: t.cpu(), p)
    _, cpu_ids, _ = moe.route(cpu_p["router"]["w"], x[0].cpu(), ocfg)
    check(torch.equal(ids.cpu(), cpu_ids),
          "moe overflow: the card and the CPU route differently")
    cy, caux = moe.moe_apply(cpu_p, x.cpu(), ocfg, decode=False)
    err = float((y.cpu() - cy).abs().max())
    check(err <= MOE_CPU_TOL and abs(float(aux) - float(caux)) <= MOE_CPU_TOL,
          f"moe overflow: card vs CPU {err}")
    return {"tokens": MOE_OVERFLOW_T, "capacity": C,
            "dropped_assignments": dropped,
            "assignments": MOE_OVERFLOW_T * cfg.top_k,
            "max_abs_err_vs_cpu": err, "bit_equal": True}


def phase_moe_model(torch, configs, get_model, engine_mod, moe):
    """deepseek-moe-16b at full width (f32, 2 layers): the paged engine's
    greedy transcripts in ``direct`` and ``gather`` decode modes against
    the kernel-free oracle on the card, teacher-forced; the paged kernel
    launches n_layers x decode steps in ``direct``, the contiguous one in
    ``gather``.  Then the capacity-overflow check.  The decode capacity
    factor is n_experts / top_k (see the note at ``MOE_ARCH``).  ->
    (record, cfg, params)."""
    cfg = configs.get_config(MOE_ARCH)
    cfg = cfg.scaled(n_layers=2, param_dtype="float32",
                     compute_dtype="float32",
                     decode_capacity_factor=cfg.n_experts / cfg.top_k)
    api = get_model(cfg)
    params = api.init(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                      device=DEVICE)
    rng = np.random.RandomState(1)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (3, 8, 9, 17, 30)]
    steps, memo, modes = 6, {}, {}
    for mode, kern in (("direct", "paged_decode_attention"),
                       ("gather", "decode_attention")):
        eng = engine_mod.InferenceEngine(
            cfg, params, device=DEVICE, max_num_seqs=4,
            max_num_batched_tokens=256, max_len=128,
            prefill_buckets=(16, 32), paged=True, block_size=16,
            paged_decode_mode=mode)
        zero_launches()
        uids = [eng.submit(p, max_new_tokens=steps) for p in prompts]
        done = eng.run()
        torch.cuda.synchronize()
        where = f"moe model {mode}"
        launches = check_launches(
            where, **{kern: cfg.n_layers * eng.stats.decode_steps})[kern]
        check(launches > 0, f"{where}: no decode step ran")
        outs = [done[u].output for u in uids]
        flips = teacher_forced(torch, get_model, cfg, params, prompts, outs,
                               where, memo)
        modes[mode] = {"kernel": kern, "launches": launches,
                       "decode_steps": eng.stats.decode_steps,
                       "transcripts_equal": not flips,
                       "teacher_forced_flips": flips, "outs": outs}
    record = {"config": cfg.name, "layers": cfg.n_layers,
              "d_model": cfg.d_model, "experts": cfg.n_experts,
              "top_k": cfg.top_k, "vocab": cfg.vocab, "dtype": "float32",
              "decode_capacity_factor": cfg.decode_capacity_factor,
              "prompt_lens": [len(p) for p in prompts],
              "new_tokens": steps,
              "modes": {m: {k: v for k, v in r.items() if k != "outs"}
                        for m, r in modes.items()},
              "modes_agree": modes["direct"]["outs"] == modes["gather"]["outs"],
              "overflow": moe_overflow(torch, moe, cfg, params)}
    return record, cfg, params


def spec_run(torch, target, draft, prompts, mnt):
    """A ``SpecDecodeSession`` over the two engines, run to its end on
    fresh launch counts: -> (session, transcripts, seconds)."""
    from repro_torch.serving.engine import SpecDecodeSession

    sess = SpecDecodeSession(target, draft, k=SPEC_K)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    uids = [sess.submit(p, max_new_tokens=mnt) for p in prompts]
    done = sess.run()
    torch.cuda.synchronize()
    return sess, [done[u].output for u in uids], time.perf_counter() - t0


def spec_launches(where, target, draft, dcfg):
    """The draft's decodes launch its engine's decode kernel (paged or
    contiguous) n_layers times a draft step; the target verifies through
    ``extend`` and launches no decode kernel while speculating."""
    kern = "paged_decode_attention" if draft.paged else "decode_attention"
    launches = check_launches(where,
                              **{kern: dcfg.n_layers * draft.stats.steps})
    check(target.stats.decode_steps == 0 and draft.stats.steps > 0,
          f"{where}: target decode steps {target.stats.decode_steps}, "
          f"draft steps {draft.stats.steps}")
    return launches[kern]


def spec_stats_check(where, sess):
    ss = sess.spec_stats()
    check(ss["proposed"] > 0 and ss["enabled"]
          and 0.0 <= ss["acceptance_rate"] <= 1.0,
          f"{where}: spec stats {ss}")
    return ss


def phase_spec_f32(torch, get_model, engine_mod, cfg, params):
    """Speculative decoding on the card, f32 and exact: phase 17's target
    with a draft of the same config cut to its one dense layer, drawn from
    seed 1, paged/paged and paged/slot: the transcripts of the plain
    target engine (where a token differs, the kernel-free oracle's
    top-two gap there is under MODEL_GAP_TOL)."""
    kw = dict(max_num_seqs=4, max_num_batched_tokens=256, max_len=128,
              prefill_buckets=(16, 32), block_size=16)
    rng = np.random.RandomState(4)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (5, 9, 3, 17)]
    mnt = 10
    plain = engine_mod.InferenceEngine(cfg, params, device=DEVICE,
                                       paged=True, **kw)
    uids = [plain.submit(p, max_new_tokens=mnt) for p in prompts]
    done = plain.run()
    want = [done[u].output for u in uids]
    dcfg = cfg.scaled(n_layers=1)
    runs, memo = [], {}
    for paged_d in (True, False):
        where = f"spec f32 paged/{'paged' if paged_d else 'slot'}"
        target = engine_mod.InferenceEngine(cfg, params, device=DEVICE,
                                            paged=True, **kw)
        draft = engine_mod.make_engine_from_scratch(
            dcfg, seed=1, device=DEVICE, paged=paged_d, **kw)
        sess, got, secs = spec_run(torch, target, draft, prompts, mnt)
        launches = spec_launches(where, target, draft, dcfg)
        flips = [] if got == want else teacher_forced(
            torch, get_model, cfg, params, prompts, got, where, memo)
        runs.append({"draft_pool": "paged" if paged_d else "slot",
                     "spec": spec_stats_check(where, sess),
                     "equal_to_plain": got == want,
                     "teacher_forced_flips": flips,
                     "draft_launches": launches,
                     "draft_steps": draft.stats.steps, "seconds": secs})
        del target, draft, sess
    return {"target": f"{cfg.name} f32 x {cfg.n_layers} layers",
            "draft": f"{cfg.name} f32 x {dcfg.n_layers} dense layer, seed 1",
            "k": SPEC_K, "prompt_lens": [len(p) for p in prompts],
            "new_tokens": mnt, "runs": runs}


def moe_decode_timing(torch, engine_mod, moe, cfg, params):
    """One engine alone (phase 19's settings and weights): the host time
    of a decode step of 8 sequences (synchronised, median of 10), and
    the device time of one MoE layer's FFN at that batch (CUDA events)
    beside its bound, the layer's expert, shared and router weights read
    once at 3.35 TB/s."""
    from repro_torch.training.optim import tree_leaves

    eng = engine_mod.InferenceEngine(cfg, params, device=DEVICE,
                                     **MAIN_PATH_ENGINE)
    rng = np.random.RandomState(3)
    for n in main_path_prompt_lens(rng, MAIN_PATH_ENGINE["max_num_seqs"]):
        eng.submit(list(map(int, rng.randint(0, cfg.vocab, size=int(n)))),
                   max_new_tokens=MAIN_PATH_NEW_TOKENS)
    zero_launches()
    while eng.queue or any(r.pending_tokens or not r.output
                           for r in eng.running.values()):
        eng.step()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check_launches("moe decode timing", paged_decode_attention=cfg.n_layers
                   * eng.stats.decode_steps)
    batch = len(eng.running)
    del eng
    p = params["blocks"][cfg.first_dense_layers]["moe"]
    x = card_randn(torch, torch.Generator(device=DEVICE).manual_seed(5),
                   (batch, 1, cfg.d_model), cfg.cdtype)
    ffn_ms = cuda_ms(lambda: moe.moe_apply(p, x, cfg, decode=True), 20)
    layer_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(p))
    step_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params)) \
        - params["embed"]["table"].numel() \
        * params["embed"]["table"].element_size()
    return {"batch": batch, "decode_step_ms": sorted(times)[len(times) // 2],
            "decode_step_ms_all": times,
            "moe_layer_ffn_ms": ffn_ms,
            "moe_layer_weight_gb": layer_bytes / 1e9,
            "moe_layer_bound_ms": bound_ms(layer_bytes, 0,
                                           H100_BF16_FLOPS)[0],
            "moe_layers": cfg.n_layers - cfg.first_dense_layers,
            "step_weight_gb": step_bytes / 1e9,
            "step_bound_ms": bound_ms(step_bytes, 0, H100_BF16_FLOPS)[0]}


def phase_spec_bf16(torch, engine_mod, cfg, params):
    """Speculative decoding at full width, bf16: deepseek-moe-16b (28
    layers) verifying a draft that shares its parameters, beside the plain
    target engine on the same 8 prompts of 32 new tokens (the phase-19
    engine settings): acceptance, generated tokens/s of both, and the
    launches (the draft's paged decodes; none from the target).  Run at
    the config's decode capacity and again at n_experts / top_k (no
    drops), which separates what the per-batch capacity costs the
    acceptance (the verify batch holds k + 1 tokens a sequence, the
    draft's decode batch one) from bf16 rounding."""
    rng = np.random.RandomState(6)
    prompts = [list(map(int, rng.randint(0, cfg.vocab, size=int(n))))
               for n in main_path_prompt_lens(rng, 8)]
    mnt = MAIN_PATH_NEW_TOKENS
    gen = len(prompts) * mnt
    runs = []
    for run_cfg in (cfg, cfg.scaled(
            decode_capacity_factor=cfg.n_experts / cfg.top_k)):
        where = f"spec bf16 capacity {run_cfg.decode_capacity_factor:g}"
        plain = engine_mod.InferenceEngine(run_cfg, params, device=DEVICE,
                                           **MAIN_PATH_ENGINE)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        uids = [plain.submit(p, max_new_tokens=mnt) for p in prompts]
        done = plain.run()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check_launches(f"{where} plain", paged_decode_attention=cfg.n_layers
                       * plain.stats.decode_steps)
        want = [done[u].output for u in uids]
        del plain
        target = engine_mod.InferenceEngine(run_cfg, params, device=DEVICE,
                                            **MAIN_PATH_ENGINE)
        draft = engine_mod.InferenceEngine(run_cfg, params, device=DEVICE,
                                           **MAIN_PATH_ENGINE)
        sess, got, secs = spec_run(torch, target, draft, prompts, mnt)
        launches = spec_launches(where, target, draft, run_cfg)
        check(all(len(o) == mnt and all(0 <= t < cfg.vocab for t in o)
                  for o in got), f"{where}: a request came back short")
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        runs.append({
            "decode_capacity_factor": run_cfg.decode_capacity_factor,
            "spec": spec_stats_check(where, sess),
            "plain_seconds": plain_s, "plain_gen_tok_per_s": gen / plain_s,
            "spec_seconds": secs, "spec_gen_tok_per_s": gen / secs,
            "tokens_equal_to_plain": same / gen,
            "draft_launches": launches, "draft_steps": draft.stats.steps,
            "target_decode_steps": target.stats.decode_steps})
        del target, draft, sess
    return {"config": cfg.name, "layers": cfg.n_layers, "dtype": "bfloat16",
            "draft": "the target's own parameters", "k": SPEC_K,
            "requests": len(prompts), "new_tokens": mnt, "runs": runs}


# ---------------------------------------------------------------------------
# Disaggregated prefill->decode serving and QoS preemption (phases 21-22)
# ---------------------------------------------------------------------------


def export_all(pre, n):
    """Chunk-prefill on a prefill-role engine until ``n`` sequences are
    exported: -> {uid: payload}."""
    pays = {}
    for _ in range(10000):
        if len(pays) >= n:
            break
        pre.step_prefill_only()
        for uid in pre.exportable():
            pays[uid] = pre.export_sequence(uid)
    check(len(pays) == n, f"prefill engine exported {len(pays)} of {n}")
    return pays


def payload_bytes(pay):
    return sum(t.numel() * t.element_size() for t in pay["leaves"].values())


def phase_disagg_exact(torch, configs, get_model, engine_mod, client,
                       kvcache):
    """llama3.2-3b's full width cut to 2 layers, f32, on the card: a
    prefill engine exports each sequence at its first token and a decode
    engine imports and finishes it; the imported blocks, extracted again,
    equal the payload bit for bit, and the transcripts equal a unified
    engine's (where a token differs, the kernel-free oracle's top-two gap
    there is under MODEL_GAP_TOL).  The prefill engine launches no decode
    kernel, the decode engine the paged one n_layers x decode steps.
    Then a preempt -> resume on a unified engine, and ``generate_stream``
    against ``step()``."""
    cfg = configs.get_config(MAIN_PATH_ARCH).scaled(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    params = get_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(0),
                                 cfg, device=DEVICE)
    kw = dict(MAIN_PATH_ENGINE, max_len=256)

    def engine():
        return engine_mod.InferenceEngine(cfg, params, device=DEVICE, **kw)

    rng = np.random.RandomState(21)
    lens = [int(n) for n in main_path_prompt_lens(rng, 6)] + [16, 17]
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in lens]
    mnt, memo = 12, {}
    uni = engine()
    uids = [uni.submit(p, max_new_tokens=mnt) for p in prompts]
    done = uni.run()
    want = [done[u].output for u in uids]

    pre, dec = engine(), engine()
    zero_launches()
    puids = [pre.submit(p, max_new_tokens=mnt) for p in prompts]
    pays = export_all(pre, len(prompts))
    torch.cuda.synchronize()
    pre_launches = check_launches("disagg exact prefill")
    check(pre.stats.decode_steps == 0, "the prefill engine decoded")
    bit_equal = True
    moved = []
    for u in puids:
        nuid = dec.import_sequence(pays[u])
        check(nuid is not None, "disagg exact: an import was refused")
        again = kvcache.extract_blocks(dec.pool.cache,
                                       dec.running[nuid].table)
        bit_equal &= all(torch.equal(again[k], v)
                         for k, v in pays[u]["leaves"].items())
        moved.append(nuid)
    check(bit_equal, "disagg exact: imported blocks differ from the payload")
    zero_launches()
    done = dec.run()
    torch.cuda.synchronize()
    dec_launches = check_launches(
        "disagg exact decode",
        paged_decode_attention=cfg.n_layers * dec.stats.decode_steps)[
        "paged_decode_attention"]
    check(dec_launches > 0, "disagg exact: no decode step ran")
    got = [done[u].output for u in moved]
    flips = [] if got == want else teacher_forced(
        torch, get_model, cfg, params, prompts + prompts, got + want,
        "disagg exact", memo)

    # preempt -> resume: the first two sequences preempted mid-decode
    eng = engine()
    uids = [eng.submit(p, max_new_tokens=mnt) for p in prompts]
    preempted, stamps = [], {}
    zero_launches()
    for _ in range(1000):
        eng.step()
        for u in uids[:2]:
            r = eng.running.get(u)
            if (u not in preempted and r is not None and len(r.output) >= 3
                    and not r.pending_tokens):
                stamps[u] = r.first_token_at
                check(eng.preempt_sequence(u), "a decoding sequence was "
                      "not preemptable")
                preempted.append(u)
        if len(preempted) == 2:
            break
    done = eng.run()
    torch.cuda.synchronize()
    check_launches("disagg exact preempt",
                   paged_decode_attention=cfg.n_layers
                   * eng.stats.decode_steps)
    check(eng.stats.preemptions == eng.stats.preempt_resumes == 2,
          f"preemptions {eng.stats.preemptions}, resumes "
          f"{eng.stats.preempt_resumes}")
    check(all(done[u].first_token_at == stamps[u] for u in preempted),
          "a resumed sequence lost its first-token stamp")
    resumed = [done[u].output for u in uids]
    pflips = [] if resumed == want else teacher_forced(
        torch, get_model, cfg, params, prompts, resumed, "preempt resume",
        memo)

    # generate_stream vs step() on two servicers over the same weights
    svs = [client.LLMServicer(cfg, params, device=DEVICE, **kw)
           for _ in range(2)]
    payload = {"prompt": prompts[0], "max_new_tokens": mnt}
    zero_launches()
    streamed = list(svs[0].generate_stream(payload))
    uid = svs[1].submit(payload)
    stepped = []
    while not stepped:
        stepped = [res for u, res in svs[1].step() if u == uid]
    torch.cuda.synchronize()
    check_launches("generate_stream", paged_decode_attention=cfg.n_layers
                   * sum(sv.stats.decode_steps for sv in svs))
    tokens = [e["token"] for e in streamed[:-1]]
    check(tokens == streamed[-1]["tokens"] == stepped[0]["tokens"],
          "generate_stream's tokens differ from step()'s")
    return {"config": f"{cfg.name} f32 x {cfg.n_layers} layers",
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "prompt_lens": lens, "new_tokens": mnt,
            "payload_bytes": [payload_bytes(pays[u]) for u in puids],
            "imported_blocks_bit_equal": bit_equal,
            "transcripts_equal_unified": got == want,
            "teacher_forced_flips": flips,
            "prefill_launches": pre_launches,
            "decode_launches": dec_launches,
            "decode_steps": dec.stats.decode_steps,
            "preempted": len(preempted),
            "preempt_transcripts_equal": resumed == want,
            "preempt_teacher_forced_flips": pflips,
            "stream_equal_step": True}


def timed(fn, torch, log):
    """``fn`` wrapped to append its host time (ms) to ``log``, the card's
    queue drained after it (an import's copies are then done)."""
    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def handoff_alone(torch, engine_mod, cfg, params, prompts, mnt):
    """The handoff with nothing else on the card: one engine prefills and
    exports ``prompts``, another imports them (each call's host time, the
    card idle before it) and finishes them.  Call on fresh launch
    counts."""
    pre, dec = (engine_mod.InferenceEngine(cfg, params, device=DEVICE,
                                           **MAIN_PATH_ENGINE)
                for _ in range(2))
    for p in prompts:
        pre.submit(p, max_new_tokens=mnt)
    exp_ms, imp_ms, pays = [], [], []
    for _ in range(10000):
        if len(pays) == len(prompts):
            break
        pre.step_prefill_only()
        for uid in pre.exportable():
            torch.cuda.synchronize()
            pays.append(timed(pre.export_sequence, torch, exp_ms)(uid))
    for pay in pays:
        torch.cuda.synchronize()
        check(timed(dec.import_sequence, torch, imp_ms)(pay) is not None,
              "handoff alone: an import was refused")
    done = dec.run()
    torch.cuda.synchronize()
    check(len(done) == len(prompts)
          and all(len(r.output) == mnt for r in done.values()),
          "handoff alone: a sequence came back short")
    check_launches("handoff alone", paged_decode_attention=cfg.n_layers
                   * (pre.stats.decode_steps + dec.stats.decode_steps))
    check(pre.stats.decode_steps == 0, "handoff alone: the prefill engine "
          "decoded")
    sizes = [payload_bytes(p) for p in pays]
    return {"sequences": len(pays), "bytes_mean": float(np.mean(sizes)),
            "bytes_max": max(sizes),
            "export_ms_median": float(np.median(exp_ms)),
            "export_ms_max": max(exp_ms),
            "import_ms_median": float(np.median(imp_ms)),
            "import_ms_max": max(imp_ms),
            "host_gb_per_s": sum(sizes) / 1e6 / (sum(exp_ms) + sum(imp_ms))}


def qos_preempt_run(torch, client, cfg, params):
    """A WFQ servicer on a small block pool (12 usable blocks of 16, max_len
    128): two
    low-class sequences of 64 + 32 tokens fill it and decode, then a
    high-class one arrives and preempts them; every request finishes with
    its full length."""
    sv = client.LLMServicer(cfg, params, qos=True, device=DEVICE,
                            **dict(MAIN_PATH_ENGINE, max_len=128,
                                   num_blocks=13))
    from repro_torch.core.request import InferenceRequest

    rng = np.random.RandomState(22)
    mnt, results, uids, arrived = MAIN_PATH_NEW_TOKENS, {}, {}, []

    def step():
        for u, res in sv.step():
            results[u] = res
            arrived.append(u)

    def submit(name, cls):
        uids[name] = sv.submit(
            {"prompt": list(map(int, rng.randint(0, cfg.vocab, size=64))),
             "max_new_tokens": mnt},
            envelope=InferenceRequest(payload={}, tenant=name,
                                      priority=cls))

    zero_launches()
    t0 = time.perf_counter()
    submit("low1", "low")
    submit("low2", "low")
    for _ in range(1000):
        step()
        run = sv.engine.running
        if all(u in run and len(run[u].output) >= 4 for u in uids.values()):
            break
    submit("high", "high")
    for _ in range(10000):
        if len(results) == len(uids):
            break
        step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    eng = sv.engine
    check_launches("qos preempt", paged_decode_attention=cfg.n_layers
                   * eng.stats.decode_steps)
    qs = sv.qos_stats()
    check(len(results) == 3 and all(len(r["tokens"]) == mnt
                                    for r in results.values()),
          "qos preempt: a request came back short")
    check(eng.stats.preemptions >= 1
          and eng.stats.preempt_resumes == eng.stats.preemptions,
          f"qos preempt: preemptions {eng.stats.preemptions}, resumes "
          f"{eng.stats.preempt_resumes}")
    names = {u: k for k, u in uids.items()}
    return {"seconds": secs, "qos_stats": qs,
            "preemptions": eng.stats.preemptions,
            "preempt_resumes": eng.stats.preempt_resumes,
            "evicted_residencies": eng.stats.evicted_residencies,
            "decode_steps": eng.stats.decode_steps,
            "latency_s": {k: results[u]["latency_s"] for k, u in uids.items()},
            "ttft_s": {k: results[u]["ttft_s"] for k, u in uids.items()},
            "finish_order": [names[u] for u in arrived]}


def phase_disagg_serving(torch, configs, core, client, engine_mod, get_model):
    """llama3.2-3b's full published config (bf16, random weights from seed
    0) served disaggregated behind Rhapsody: a prefill group and a decode
    group of one replica each over one parameter set (``MAIN_PATH_ENGINE``),
    phase 8's traffic (16 requests a pass, 32 new tokens, greedy, cold then
    warm) addressed to the prefill group.  Every result comes back handed
    off to the decode replica, none recomputed; the paged kernel launches
    n_layers x the decode replica's decode steps and the prefill replica
    decodes never.  Then the handoff alone and a QoS preemption run on the
    same weights."""
    cfg = configs.get_config(MAIN_PATH_ARCH)
    params = get_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(0),
                                 cfg, device=DEVICE)
    n_req, mnt, where = 16, MAIN_PATH_NEW_TOKENS, "disagg serving"
    rh = core.Rhapsody(core.ResourceDescription(nodes=2, cores_per_node=16),
                       n_workers=2)
    try:
        t_up = time.perf_counter()
        rs = rh.add_service(core.ServiceDescription(
            name="llm", replicas=2, ready_timeout=600, models=[
                client.llm_model_group(
                    "prefill", cfg, params, role="prefill",
                    paired_with="decode", replicas=1, device=DEVICE,
                    **MAIN_PATH_ENGINE),
                client.llm_model_group(
                    "decode", cfg, params, role="decode", replicas=1,
                    device=DEVICE, **MAIN_PATH_ENGINE)]))
        setup_s = time.perf_counter() - t_up
        sv = {inst.endpoint.group: inst.servicer for inst in rs.instances}
        check(sorted(sv) == ["decode", "prefill"], f"groups {sorted(sv)}")
        exp_ms, imp_ms = [], []
        pre_eng, dec_eng = sv["prefill"].engine, sv["decode"].engine
        pre_eng.export_sequence = timed(pre_eng.export_sequence, torch,
                                        exp_ms)
        dec_eng.import_sequence = timed(dec_eng.import_sequence, torch,
                                        imp_ms)
        rng = np.random.RandomState(0)
        lens = main_path_prompt_lens(rng, n_req)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0 = {g: s.stats.decode_steps for g, s in sv.items()}
        zero_launches()
        passes, totals = {}, []
        for name in ("cold", "warm"):
            _, results, passes[name] = serve_pass(
                torch, core, rh, cfg, rng, lens, mnt, f"{where} {name}",
                model="prefill")
            check(all(r.get("handoff") is True and r.get("role") == "decode"
                      and not r.get("recompute") for r in results),
                  f"{where} {name}: a result was not handed off and "
                  f"imported")
            totals.append(rs.handoff_totals())
        steps = {g: s.stats.decode_steps - steps0[g] for g, s in sv.items()}
        launches = check_launches(
            where, paged_decode_attention=cfg.n_layers * steps["decode"])[
            "paged_decode_attention"]
        check(steps["prefill"] == 0 and steps["decode"] > 0,
              f"{where}: decode steps {steps}")
        check(totals == [{"exports": n, "imports": n, "recomputes": 0}
                         for n in (n_req, 2 * n_req)],
              f"{where}: handoff totals {totals}")
        errors = [inst.error for inst in rs.instances]
        check(all(e is None for e in errors), f"replica errors {errors}")
        pg = rs.stats()["per_group"]
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        rh.close()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(0)
    alone_prompts = [list(map(int, rng.randint(0, cfg.vocab, size=int(n))))
                     for n in main_path_prompt_lens(rng, n_req)]
    zero_launches()
    alone = handoff_alone(torch, engine_mod, cfg, params, alone_prompts, mnt)
    qos = qos_preempt_run(torch, client, cfg, params)
    return {"config": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.compute_dtype,
            "groups": {"prefill": 1, "decode": 1}, "shared_params": True,
            "requests_per_pass": n_req, "max_new_tokens": mnt,
            "prompt_lens": [int(x) for x in lens],
            "setup_seconds": setup_s, **passes,
            "group_ttft_p95_ms": pg["prefill"]["ttft_p95_ms"],
            "group_itl_p95_ms": pg["decode"]["itl_p95_ms"],
            "handoff_totals": totals[-1],
            "in_service_export_ms_median": float(np.median(exp_ms)),
            "in_service_import_ms_median": float(np.median(imp_ms)),
            "handoff_alone": alone, "launches": launches,
            "decode_steps": steps, "peak_mem_gb": peak, "qos": qos}


# ---------------------------------------------------------------------------
# Training the state-carrying families (phases 23-25) and the workflow
# payloads (phase 26)
# ---------------------------------------------------------------------------


def expected_train_launches(cfg, steps=1):
    """Kernel launches of ``steps`` training steps of ``cfg``: remat full
    runs each checkpointed forward twice (the forward, then the rerun in the
    backward), and the scans' backward recomputes through the plain
    version, so it launches nothing."""
    per = (2 if cfg.remat == "full" else 1) * steps
    if cfg.family == "ssm":
        return {"wkv6": per * cfg.n_layers}
    if cfg.family == "hybrid":
        return {"ssd": per * cfg.n_layers,
                "flash_attention": per * (cfg.n_layers // cfg.attn_every)}
    return {"flash_attention": per * cfg.n_layers}


def scan_grad_case(torch, name, fn, plain, inputs, dtype, tol, gtol):
    """``fn`` (the wrapper, launching the kernel once) on the card against
    ``plain`` (autograd of the plain version on float32 copies of the
    inputs): both outputs within ``tol``; every input's gradient, under
    random cotangents of both outputs, within ``gtol`` relative."""
    leaves = [t for t in inputs if t is not None]
    mine = [t.clone().requires_grad_() for t in leaves]
    ref32 = [t.float().clone().requires_grad_() for t in leaves]

    def call(f, xs):
        it = iter(xs)
        return f(*[None if t is None else next(it) for t in inputs])

    zero_launches()
    y, s = call(fn, mine)
    torch.cuda.synchronize()
    launches = check_launches(f"{name} gradient", **{name: 1})[name]
    check(y.grad_fn is not None and s.grad_fn is not None,
          f"{name}: the wrapper's outputs carry no gradient")
    py, ps = call(plain, ref32)
    err_y, ok_y = within(y.detach(), py.detach(), tol)
    err_s, ok_s = within(s.detach(), ps.detach(), SCAN_F32_TOL)
    check(ok_y and ok_s, f"{name} {dtype}: outputs {err_y} / {err_s} off "
                         f"the plain version")
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    wy = torch.randn(y.shape, generator=gen, device=DEVICE)
    ws = torch.randn(s.shape, generator=gen, device=DEVICE)
    grads = torch.autograd.grad((y, s), mine, (wy.to(y.dtype), ws))
    want = torch.autograd.grad((py, ps), ref32, (wy.to(y.dtype).float(), ws))
    worst = 0.0
    for i, (g, w, x) in enumerate(zip(grads, want, leaves)):
        check(g.dtype == x.dtype, f"{name}: gradient {i} in {g.dtype}, its "
                                  f"input in {x.dtype}")
        d = (g.float() - w).abs()
        worst = max(worst, float(d.max()))
        check(bool((d <= gtol + gtol * w.abs()).all()),
              f"{name} {dtype}: gradient {i} error {float(d.max())} > "
              f"{gtol} + {gtol} x |plain|")
    return {"kernel": name, "dtype": str(dtype).split(".")[-1],
            "shape": list(leaves[0].shape),
            "state_set": inputs[-1] is not None, "out_err": err_y,
            "state_err": err_s, "grad_err": worst, "grad_tol": gtol,
            "launches": launches}


# phase 23's shapes: the serving prefill's (``WKV_SHAPE``, ``SSD_SHAPE``)
# and a training step's, global batch x seq, where the state is carried
# over 64 chunks (rwkv6-1.6b) and 16 (zamba2-2.7b)
WKV_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 32, 64, 32)
SSD_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 80, 64, 64, 128)


def phase_scan_grads(torch, wkv_ops, wkv_ref, ssd_ops, ssd_ref):
    """Phase 23: ``wkv`` at rwkv6-1.6b's prefill and training shapes and
    ``ssd`` at zamba2-2.7b's, f32 and bf16, the initial state absent and
    set: one forward launch a call, y and the final state against the plain
    version, outputs with a ``grad_fn``, every input's gradient against
    autograd of the plain version on the card.  In f32 the Function's
    backward is that same plain version, so the gradient case checks its
    wiring (grad_fn, every cotangent, dtypes); the numerical check of the
    backward is the CPU tests' against the JAX package."""
    records = []
    for dtype, tol, gtol in ((torch.float32, SCAN_F32_TOL, F32_GRAD_TOL),
                             (torch.bfloat16, BF16_TOL, BF16_GRAD_TOL)):
        for (B, T, H, hd, L), (sB, sT, sH, P, N, sL) in (
                (WKV_SHAPE, SSD_SHAPE), (WKV_TRAIN_SHAPE, SSD_TRAIN_SHAPE)):
            for scale in (0.0, 0.1):
                gen = torch.Generator(device=DEVICE).manual_seed(2300)
                records.append(scan_grad_case(
                    torch, "wkv6",
                    lambda r, k, v, lw, u, s0, L=L: wkv_ops.wkv(
                        r, k, v, lw, u, chunk=L, s0=s0),
                    lambda r, k, v, lw, u, s0, L=L: wkv_ref.wkv_chunked_ref(
                        r, k, v, lw, u, L, s0),
                    wkv_inputs(torch, gen, dtype, B, T, H, hd, scale),
                    dtype, tol, gtol))
                records.append(scan_grad_case(
                    torch, "ssd",
                    lambda x, dt, A, Bm, Cm, h0, sL=sL: ssd_ops.ssd(
                        x, dt, A, Bm, Cm, chunk=sL, h0=h0),
                    lambda x, dt, A, Bm, Cm, h0, sL=sL:
                        ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, sL, h0),
                    ssd_inputs(torch, gen, dtype, sB, sT, sH, P, N, scale),
                    dtype, tol, gtol))
                gc.collect()
                torch.cuda.empty_cache()
    return records


# phase 24: card vs CPU, f32, at full width cut in depth; a gradient leaf
# within 1e-3 of its largest magnitude plus 1e-3 relative (float32 sums
# over d 2048-2560 and vocab 32000-65536 in another order, and the kernel's
# forward feeding the backward on the card)
STATE_TRAIN_CUTS = (("rwkv6-1.6b", {"n_layers": 2}, 2, 64),
                    ("zamba2-2.7b", {"n_layers": 6}, 1, 256))
STATE_GRAD_TOL = 1e-3


def phase_state_train_step(torch, configs, get_model, optim, train):
    """Phase 24: rwkv6-1.6b (2 layers) and zamba2-2.7b (one group: 6 Mamba2
    layers and the shared block) at full width in f32: every gradient leaf
    of ``loss`` on the card against the CPU's, then one AdamW step held to
    phase 14's tolerances (Adam eps 1e-3)."""
    records = []
    for arch, cut, B, T in STATE_TRAIN_CUTS:
        cfg = configs.get_config(arch).scaled(
            param_dtype="float32", compute_dtype="float32", **cut)
        api = get_model(cfg)
        opt = optim.OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                    decay_steps=10)
        cpu, _ = train.init_state(torch.Generator().manual_seed(0), api, cfg,
                                  opt, device="cpu")
        card = {"params": optim.tree_map(
            lambda t: t.detach().to(DEVICE, copy=True).requires_grad_(),
            cpu["params"])}
        card["opt"] = optim.adamw_init(card["params"], opt)
        rng = np.random.RandomState(24)
        toks = torch.from_numpy(
            rng.randint(0, cfg.vocab, (B, T + 1)).astype(np.int32))
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "targets": toks[:, 1:].contiguous()}
        gbatch = {k: v.to(DEVICE) for k, v in batch.items()}
        loss_cpu, _ = api.loss(cpu["params"], batch, cfg)
        g_cpu = torch.autograd.grad(loss_cpu,
                                    optim.tree_leaves(cpu["params"]))
        zero_launches()
        loss_card, _ = api.loss(card["params"], gbatch, cfg)
        g_card = torch.autograd.grad(loss_card,
                                     optim.tree_leaves(card["params"]))
        loss_cpu, loss_card = loss_cpu.detach(), loss_card.detach()
        torch.cuda.synchronize()
        grad_launches = check_launches(f"{arch} gradient",
                                       **expected_train_launches(cfg))
        check(abs(float(loss_card) - float(loss_cpu))
              <= 1e-5 * abs(float(loss_cpu)),
              f"{arch}: loss {float(loss_card)} on the card != "
              f"{float(loss_cpu)} on the CPU")
        worst = 0.0
        names = [p for p, _ in optim.named_leaves(cpu["params"])]
        for path, a, b in zip(names, g_card, g_cpu):
            d = (a.cpu() - b).abs()
            scale = float(b.abs().max())
            worst = max(worst, float(d.max()) / max(scale, 1e-30))
            check(bool((d <= STATE_GRAD_TOL * scale
                        + STATE_GRAD_TOL * b.abs()).all()),
                  f"{arch}: gradient of {path} off the CPU's by "
                  f"{float(d.max())} (largest {scale})")
        del g_cpu, g_card
        step = train.make_train_step(api, cfg, train.TrainConfig(
            optimizer=opt))
        _, m_cpu = step(cpu, batch)
        zero_launches()
        _, m_card = step(card, gbatch)
        torch.cuda.synchronize()
        step_launches = check_launches(f"{arch} train step",
                                       **expected_train_launches(cfg))
        check(abs(float(m_card["loss"]) - float(m_cpu["loss"]))
              <= 1e-5 * abs(float(m_cpu["loss"])),
              f"{arch} step: loss {float(m_card['loss'])} != "
              f"{float(m_cpu['loss'])}")
        perr = 0.0
        for a, b in zip(optim.tree_leaves(card["params"]),
                        optim.tree_leaves(cpu["params"])):
            d = (a.detach().cpu() - b.detach()).abs()
            perr = max(perr, float(d.max()))
            check(bool((d <= 2e-5 + 2e-3 * b.detach().abs()).all()),
                  f"{arch} step: parameter error {float(d.max())}")
        records.append({
            "config": arch, "cut": cut, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "batch": B, "seq": T,
            "loss_cpu": float(loss_cpu), "loss_card": float(loss_card),
            "grad_leaves": len(names), "grad_max_err_rel": worst,
            "grad_tol": STATE_GRAD_TOL, "grad_launches": grad_launches,
            "step_loss_cpu": float(m_cpu["loss"]),
            "step_loss_card": float(m_card["loss"]),
            "step_max_param_err": perr, "step_launches": step_launches})
        del cpu, card
        gc.collect()
        torch.cuda.empty_cache()
    return records


STATE_TRAIN_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")


def phase_state_train_full(torch, configs, get_model, optim, train, data,
                           arch):
    """Phase 25: ``arch`` at full width (bf16, remat full, random weights
    from seed 0) through ``DataPipeline``, ``init_state`` and
    ``make_train_step``, global batch 2 x seq 2048, AdamW, 3 timed steps;
    then one more step under ``torch.profiler``, from which the scans'
    backward span (``wkv6/backward`` or ``ssd/backward``, one a layer) is
    read: its host and device time summed over the step's layers, and its
    share of the profiled step."""
    t_up = time.perf_counter()
    cfg = configs.get_config(arch)
    api = get_model(cfg)
    tcfg = train_tcfg(TRAIN_SEQ)
    pipe = data.DataPipeline(data.DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH),
        device=DEVICE)
    state, _ = train.init_state(torch.Generator(device=DEVICE).manual_seed(0),
                                api, cfg, tcfg.optimizer, device=DEVICE)
    step = train.make_train_step(api, cfg, tcfg)
    n_params = sum(p.numel() for p in optim.tree_leaves(state["params"]))
    state_bytes = tree_bytes(state)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_up
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    times, losses, norms = [], [], []
    for _ in range(TRAIN_STEPS):
        batch = pipe.next_batch()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = check_launches(f"{arch} training",
                              **expected_train_launches(cfg, TRAIN_STEPS))
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses + norms),
          f"{arch} training: loss {losses} / grad norm {norms}")
    check(1.0 < losses[0] < 3 * math.log(cfg.vocab),
          f"{arch} training: first loss {losses[0]} is not near ln(vocab) "
          f"= {math.log(cfg.vocab)}")
    median = sorted(times)[len(times) // 2]

    span = "wkv6/backward" if cfg.family == "ssm" else "ssd/backward"
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    pcfg = cfg
    if arch in PROFILED_LAYERS:  # the profiled step at its width, cut
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        pcfg = cfg.scaled(n_layers=PROFILED_LAYERS[arch])
        state, _ = train.init_state(
            torch.Generator(device=DEVICE).manual_seed(0), api, pcfg,
            tcfg.optimizer, device=DEVICE)
        step = train.make_train_step(api, pcfg, tcfg)
        state, _ = step(state, pipe.next_batch())  # warm, as the 3 above
    batch = pipe.next_batch()
    zero_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    check_launches(f"{arch} profiled step", **expected_train_launches(pcfg))
    check(math.isfinite(float(m["loss"])), f"{arch} profiled step: loss "
                                           f"{float(m['loss'])}")
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    # the span has two rows, its host range and its device annotation, each
    # summed over the step's calls; kernels carry no CPU time of their own
    rec = [e for e in ka if e.key == span]
    check(bool(rec), f"no {span} span in the profiled {arch} step")
    kernels_us = sum(dev_us(e) for e in ka if dev_us(e) > 0
                     and e.self_cpu_time_total == 0 and e.key != span)
    span_device_ms = max(dev_us(e) for e in rec) / 1e3
    del state, step, prof, ka
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab,
            "dtype": cfg.compute_dtype, "remat": cfg.remat,
            "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "setup_seconds": setup_s, "step_seconds": times,
            "step_median_s": median,
            "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / median,
            "losses": losses, "grad_norms": norms, "launches": launches,
            "peak_mem_gb": peak, "state_bytes": state_bytes,
            "profiled_step": {
                "layers": pcfg.n_layers, "seconds": window, "span": span,
                "span_calls": max(e.count for e in rec),
                "span_host_ms": max(e.cpu_time_total for e in rec) / 1e3,
                "span_device_ms": span_device_ms,
                "span_share": span_device_ms / (window * 1e3),
                "device_busy_share": kernels_us / (window * 1e6)}}


# phase 26: the simulation payloads at the reference's default sizes (card
# vs CPU), then at sizes a simulation user runs
HEAT_TIMED = (4096, 100)  # grid side, steps
LJ_TIMED = (4096, 10)  # particles, steps
AGENTS, AGENT_DECISIONS, AGENT_NEW_TOKENS = 8, 4, 16


def phase_workflows(torch, configs, get_model, core, sim, torchrt, local,
                    bench_agentic, bench_run, bench_common):
    """Phase 26: the payloads on the card against the CPU from one seed
    (heat within 1e-6, LJ and the surrogate within 1e-4 relative), timed at
    a 4096^2 heat grid over 100 steps and 4096 LJ particles over 10 steps;
    ``TorchBackend`` beside the pool backend in one ``Rhapsody``; exp6's
    agent population behind llama3.2-3b at full width (bf16, one paged
    replica); then exp1, exp2 and exp5 of ``benchmarks_torch`` on the
    card."""
    out = {}
    checks = []
    # (atol, rtol): heat within 1e-6; LJ and the surrogate within 1e-4
    # relative, with a 1e-6 floor for values near 0
    for name, fn, kw, tol in (
            ("heat_stencil", sim.heat_stencil, {"_ranks": 4}, (1e-6, 0.0)),
            ("lj_step", sim.lj_step, {}, (1e-6, 1e-4)),
            ("surrogate_eval", sim.surrogate_eval, {}, (1e-6, 1e-4))):
        zero_launches()
        got = fn(seed=26, device=DEVICE, **kw)
        check_launches(name)
        want = fn(seed=26, device="cpu", **kw)
        d = np.abs(got - want)
        ok = got.shape == want.shape and bool(
            np.all(d <= tol[0] + tol[1] * np.abs(want)))
        check(ok and bool(np.isfinite(got).all()),
              f"{name}: card vs CPU error {float(d.max())}")
        checks.append({"payload": name, "shape": list(got.shape),
                       "max_abs_err": float(d.max()), "tol": tol})
    out["card_vs_cpu"] = checks
    # the step functions alone on inputs already on the card (the rates);
    # then the whole payload call: the CPU draw, the copies both ways and
    # the steps
    n, steps = HEAT_TIMED
    n_lj, steps_lj = LJ_TIMED
    grid = sim._heat_draw(n, 0).to(DEVICE)
    pos = sim._lj_draw(n_lj, 0).to(DEVICE)
    step_fns = {
        "heat_stencil": lambda: sim._heat_steps(grid, steps),
        "lj_step": lambda: sim._lj_steps(pos, torch.zeros_like(pos),
                                         steps_lj)[0]}
    timed = {}
    for name, fn, kw in (
            ("heat_stencil", sim.heat_stencil, {"n": n, "steps": steps}),
            ("lj_step", sim.lj_step,
             {"n_particles": n_lj, "steps": steps_lj})):
        res = step_fns[name]()
        check(bool(torch.isfinite(res).all()), f"{name}: non-finite steps")
        step_ms = cuda_ms(step_fns[name], reps=3)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = fn(device=DEVICE, **kw)
            ts.append(time.perf_counter() - t0)
        check(bool(np.isfinite(res).all()), f"{name}: non-finite result")
        timed[name] = {**kw, "steps_ms": step_ms, "call_seconds": ts,
                       "call_median_s": sorted(ts)[1]}
    timed["heat_stencil"]["cell_updates_per_s"] = \
        (n - 2) ** 2 * steps / (timed["heat_stencil"]["steps_ms"] / 1e3)
    timed["lj_step"]["pair_evals_per_s"] = \
        n_lj * n_lj * steps_lj / (timed["lj_step"]["steps_ms"] / 1e3)
    del grid, pos
    out["timed"] = timed

    # TorchBackend beside the pool backend in one allocation
    backends = {"pool": local.PoolBackend(n_workers=2),
                "torch": torchrt.TorchBackend(device=DEVICE)}
    rh = core.Rhapsody(core.ResourceDescription(nodes=4, cores_per_node=8),
                       backends=backends, partitions={"pool": 2, "torch": 2})
    try:
        xs = [torch.arange(16.0, device=DEVICE) + i for i in range(4)]
        t_tasks = [core.TaskDescription(
            fn=lambda x: (x * x + 1.0).sum(), args=(x,), partition="torch",
            task_type="torch_compute") for x in xs]
        p_tasks = [core.TaskDescription(fn=lambda i=i: i * 2,
                                        partition="pool", task_type="py_fn")
                   for i in range(4)]
        zero_launches()
        uids = rh.submit(t_tasks + p_tasks)
        check(rh.wait(uids, timeout=120), "TorchBackend tasks timed out")
        check_launches("TorchBackend composition")
        got = [float(rh.result(t.uid)) for t in t_tasks]
        want = [float(((torch.arange(16.0) + i) ** 2 + 1.0).sum())
                for i in range(4)]
        check(got == want and rh.result(p_tasks[3].uid) == 6,
              f"TorchBackend composition: {got} != {want}")
        stats = {k: b.stats() for k, b in backends.items()}
        check(stats["torch"]["executed"] == 4
              and stats["pool"]["executed"] == 4,
              f"TorchBackend composition: {stats}")
        out["composition"] = stats
    finally:
        rh.close()

    # exp6's agent population behind llama3.2-3b at full width
    cfg = configs.get_config(MAIN_PATH_ARCH)
    params = get_model(cfg).init(
        torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE)
    zero_launches()
    pop = bench_agentic.run_population(
        AGENTS, AGENT_DECISIONS, device=DEVICE, cfg=cfg, params=params,
        max_new_tokens=AGENT_NEW_TOKENS)
    pop["launches"] = check_launches(
        "agent population",
        paged_decode_attention=cfg.n_layers * pop["decode_steps"])[
        "paged_decode_attention"]
    check(pop["decisions"] == AGENTS * AGENT_DECISIONS
          and pop["tasks"] == 2 * AGENTS * AGENT_DECISIONS
          and not pop["errors"] and not pop["decision_errors"]
          and not pop["replica_errors"] and pop["decode_steps"] > 0,
          f"agent population: {pop}")
    out["agents"] = {**pop, "layers": cfg.n_layers, "d_model": cfg.d_model,
                     "dtype": cfg.compute_dtype}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the port's benchmark suites on the card
    suites = ["exp1_scaling", "exp2_heterogeneity", "exp5_coupling"]
    zero_launches()
    t0 = time.perf_counter()
    payload, failures = bench_run.run_suites(bench_common.Reporter(), suites,
                                             DEVICE)
    check_launches("benchmarks_torch suites")
    check(not failures, f"benchmarks_torch suites failed: {failures}")
    out["benchmarks_torch"] = {"seconds": time.perf_counter() - t0,
                               **payload}
    return out


# ---------------------------------------------------------------------------
# The encoder-decoder (whisper-small) and vision-prefix (internvl2-1b)
# families (phases 27-29): the contiguous decode kernel, self and cross, and
# the flash kernel in training
# ---------------------------------------------------------------------------


def decode_per_step(cfg):
    """Contiguous-decode launches of one slot-pool decode step of a
    transformer: each decoder layer's self-attention, and its
    cross-attention in an encoder-decoder."""
    return cfg.n_layers * (2 if cfg.family == "encdec" else 1)


def stub_batch(torch, cfg, tokens, frames=64):
    """``{"tokens"}`` on the card plus the family's zero frontend stub, as
    the slot engine's prefill makes it: ``frames`` zero audio frames
    (encdec) or ``vision_tokens`` zero patches (vlm)."""
    t = torch.tensor(tokens, device=DEVICE)
    batch = {"tokens": t}
    n = {"encdec": frames, "vlm": cfg.vision_tokens or 16}.get(cfg.family)
    if n:
        name = "frame_embeds" if cfg.family == "encdec" else "patch_embeds"
        batch[name] = torch.zeros((t.shape[0], n, cfg.d_model),
                                  device=DEVICE)
    return batch


@contextlib.contextmanager
def plain_decode(ops, ref):
    """Within it, ``ops.decode_attention`` runs its plain version on the
    card, so a model's ``decode_step`` launches no kernel (the oracle of
    phase 27)."""
    kernel_path = ops.decode_attention

    def plain(q, k, v, kv_length):
        B, _, Hq, D = q.shape
        qg = q.reshape(B, k.shape[2], Hq // k.shape[2], D)
        return ref.decode_ref(qg, k, v, kv_length).reshape(q.shape)

    ops.decode_attention = plain
    try:
        yield
    finally:
        ops.decode_attention = kernel_path


def slot_oracle(torch, ops, ref, engine_mod, kvcache, cfg, params, eng,
                prompt, out):
    """The logits the slot engine's path gives each token of ``out`` for
    ``prompt`` alone, with no kernel: the prompt right-padded into its
    bucket and prefilled with the engine's zero stub, whisper's cross K/V
    zero-padded to the pool's 1500 positions and the length set to the
    prompt's (so a VLM decodes from position n, inside its prefix, as the
    reference's engine does), then ``decode_step`` on the plain version,
    fed the transcript."""
    api = eng.api
    n = min(len(prompt), eng.max_len - 1)
    bucket = engine_mod._bucket(n, eng.buckets)
    n = min(n, bucket)
    tokens = [0] * bucket
    tokens[:n] = prompt[-n:]
    with torch.no_grad(), plain_decode(ops, ref):
        cache, logits = api.prefill(
            params, stub_batch(torch, cfg, [tokens],
                               frames=engine_mod.ENC_STUB_FRAMES),
            cfg, max_len=eng.max_len, last_only=False)
        for name in ("cross_k", "cross_v"):
            if name in cache:
                pad = kvcache.WHISPER_FRAMES - cache[name].shape[2]
                cache[name] = torch.nn.functional.pad(
                    cache[name], (0, 0, 0, 0, 0, pad)).contiguous()
        cache["len"].fill_(n)
        seq = [logits[0, n - 1]]
        for tok in out[:-1]:
            cache, step = api.decode(params, cache,
                                     torch.tensor([tok], device=DEVICE), cfg)
            seq.append(step[0])
    return seq


def phase_encdec_vlm_model(torch, configs, get_model, engine_mod, kvcache,
                           ops, ref):
    """Phase 27, f32 on the card: whisper-small at full width and depth (12
    + 12 layers) and internvl2-1b at full width (24 layers), random weights
    from seed 0, through the slot engine (4 requests, 6 new tokens): every
    token against ``slot_oracle`` (no kernel), flipping only where the
    oracle's top-two gap is under MODEL_GAP_TOL; the contiguous decode
    kernel ``decode_per_step`` (24) times a step.  Then whisper's
    ``prefill`` over 1500 random frames and 8 ``decode_step``s with the
    kernel against the same without it (``ENCDEC_F32_TOL``, greedy equal
    but under the gap)."""
    records = []
    for arch in ENCDEC_VLM_ARCHS:
        cfg = configs.get_config(arch).scaled(param_dtype="float32",
                                              compute_dtype="float32")
        api = get_model(cfg)
        params = api.init(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                          device=DEVICE)
        eng = engine_mod.InferenceEngine(
            cfg, params, device=DEVICE, paged=False, max_num_seqs=4,
            max_num_batched_tokens=1024,
            max_len=ENCDEC_VLM_ENGINE[arch]["max_len"])
        lens = (3, 17, 64, 300)
        rng = np.random.RandomState(27)
        prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
                   for n in lens]
        zero_launches()
        uids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        done = eng.run()
        torch.cuda.synchronize()
        launches = check_launches(
            f"{arch} engine",
            decode_attention=decode_per_step(cfg) * eng.stats.decode_steps)
        outs = [done[u].output for u in uids]
        flips = []
        zero_launches()
        for p, out in zip(prompts, outs):
            seq = slot_oracle(torch, ops, ref, engine_mod, kvcache, cfg,
                              params, eng, p, out)
            for i, (tok, logits) in enumerate(zip(out, seq)):
                best = int(logits.argmax())
                if tok != best:
                    gap = float(logits[best] - logits[tok])
                    check(gap < MODEL_GAP_TOL,
                          f"{arch}: engine token {tok} != oracle {best} at "
                          f"step {i} of a {len(p)}-token prompt, gap {gap}")
                    flips.append({"prompt_len": len(p), "step": i,
                                  "gap": gap})
        check_launches(f"{arch} oracle")  # the oracle ran no kernel
        rec = {"config": arch, "layers": cfg.n_layers,
               "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
               "vocab": cfg.vocab, "prompt_lens": lens, "new_tokens": 6,
               "transcripts_equal": not flips, "teacher_forced_flips": flips,
               "launches": launches, "decode_steps": eng.stats.decode_steps}
        del eng
        if cfg.family == "encdec":
            rec["audio_context"] = whisper_audio_decode(torch, ops, ref, api,
                                                        cfg, params)
        records.append(rec)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return records


def whisper_audio_decode(torch, ops, ref, api, cfg, params):
    """``prefill`` over WHISPER_AUDIO_FRAMES random frames (x 0.02, seed
    27) and a 16-token prompt, batch 2, then 8 ``decode_step``s with the
    kernel (self and cross attention, the cross one at S 1500) against the
    same steps on the plain version, both fed the kernel's greedy tokens:
    every step's logits within ENCDEC_F32_TOL."""
    gen = torch.Generator(device=DEVICE).manual_seed(27)
    frames = torch.randn((2, WHISPER_AUDIO_FRAMES, cfg.d_model),
                         generator=gen, device=DEVICE) * 0.02
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                           device=DEVICE)
    batch = {"tokens": tokens, "frame_embeds": frames}
    steps, runs = 8, {}
    with torch.no_grad():
        feed = None
        for name in ("kernel", "plain"):
            cache, logits = api.prefill(params, batch, cfg, max_len=64)
            check(cache["cross_k"].shape[2] == WHISPER_AUDIO_FRAMES,
                  f"whisper cross cache {tuple(cache['cross_k'].shape)}")
            seq = [logits]
            zero_launches()
            for i in range(steps):
                tok = seq[-1].argmax(-1) if feed is None else feed[i]
                if name == "plain":
                    with plain_decode(ops, ref):
                        cache, logits = api.decode(params, cache, tok, cfg)
                else:
                    cache, logits = api.decode(params, cache, tok, cfg)
                seq.append(logits)
            torch.cuda.synchronize()
            runs[name] = (seq, check_launches(
                f"whisper audio decode ({name})",
                decode_attention=(decode_per_step(cfg) * steps
                                  if name == "kernel" else 0)))
            feed = [t.argmax(-1) for t in seq[:-1]]
    (ks, launches), (ps, _) = runs["kernel"], runs["plain"]
    err, flips = 0.0, []
    for i, (a, b) in enumerate(zip(ks, ps)):
        e, ok = within(a, b, ENCDEC_F32_TOL)
        check(ok, f"whisper audio decode step {i}: kernel vs plain error {e}")
        err = max(err, e)
        for row in range(a.shape[0]):
            ka, pb = int(a[row].argmax()), int(b[row].argmax())
            if ka != pb:
                gap = float(b[row, pb] - b[row, ka])
                check(gap < MODEL_GAP_TOL, f"whisper audio decode step {i}: "
                                           f"token {ka} != {pb}, gap {gap}")
                flips.append({"step": i, "row": row, "gap": gap})
    return {"frames": WHISPER_AUDIO_FRAMES, "batch": 2, "prompt": 16,
            "decode_steps": steps, "max_err": err, "tol": ENCDEC_F32_TOL,
            "greedy_flips": flips, "launches": launches}


def phase_encdec_vlm_train(torch, configs, get_model, optim, train,
                           make_batch):
    """Phase 29: first one step of each family at full width cut to 2 (+
    2) layers in f32, card vs CPU, at phase 14's tolerances (Adam eps
    1e-3); then whisper-small and internvl2-1b at full width (bf16, remat
    full, random weights from seed 0) through ``init_state`` and
    ``make_train_step``, AdamW, 3 timed steps on ``make_batch`` batches
    with stubbed frontends: internvl2-1b 2 x 2048 text tokens after 256
    patches, whisper-small 2 x 448 tokens over 1500 frames."""
    shapes = {"whisper-small": (WHISPER_TEXT_CTX, WHISPER_AUDIO_FRAMES),
              "internvl2-1b": (TRAIN_SEQ, VISION_TOKENS)}
    cut_steps, records = [], []
    for arch in ENCDEC_VLM_ARCHS:
        cfg = configs.get_config(arch).scaled(
            param_dtype="float32", compute_dtype="float32", n_layers=2,
            **({"enc_layers": 2, "dec_layers": 2}
               if arch == "whisper-small" else {}))
        api = get_model(cfg)
        opt = optim.OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                    decay_steps=10)
        cpu, _ = train.init_state(torch.Generator().manual_seed(0), api, cfg,
                                  opt, device="cpu")
        card = {"params": optim.tree_map(
            lambda t: t.detach().to(DEVICE, copy=True).requires_grad_(),
            cpu["params"])}
        card["opt"] = optim.adamw_init(card["params"], opt)
        batch = make_batch(cfg, 2, 64, torch.Generator().manual_seed(29),
                           device="cpu", frontend_len=shapes[arch][1])
        step = train.make_train_step(api, cfg, train.TrainConfig(
            optimizer=opt))
        _, m_cpu = step(cpu, batch)
        zero_launches()
        _, m_card = step(card, {k: v.to(DEVICE) for k, v in batch.items()})
        torch.cuda.synchronize()
        launches = check_launches(f"{arch} cut step",
                                  **expected_train_launches(cfg))
        loss_cpu, loss_card = float(m_cpu["loss"]), float(m_card["loss"])
        check(abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu),
              f"{arch} cut step: loss {loss_card} on the card != {loss_cpu} "
              f"on the CPU")
        worst = 0.0
        for a, b in zip(optim.tree_leaves(card["params"]),
                        optim.tree_leaves(cpu["params"])):
            d = (a.detach().cpu() - b.detach()).abs()
            worst = max(worst, float(d.max()))
            check(bool((d <= 2e-5 + 2e-3 * b.detach().abs()).all()),
                  f"{arch} cut step: parameter error {float(d.max())}")
        cut_steps.append({"config": arch, "layers": cfg.n_layers,
                          "enc_layers": cfg.enc_layers,
                          "frontend": shapes[arch][1], "seq": 64,
                          "loss_cpu": loss_cpu, "loss_card": loss_card,
                          "max_param_err": worst, "launches": launches})
        del cpu, card
        gc.collect()
        torch.cuda.empty_cache()

    for arch in ENCDEC_VLM_ARCHS:
        seq, front = shapes[arch]
        t_up = time.perf_counter()
        cfg = configs.get_config(arch)
        api = get_model(cfg)
        tcfg = train_tcfg(seq)
        state, _ = train.init_state(
            torch.Generator(device=DEVICE).manual_seed(0), api, cfg,
            tcfg.optimizer, device=DEVICE)
        step = train.make_train_step(api, cfg, tcfg)
        n_params = sum(p.numel() for p in optim.tree_leaves(state["params"]))
        state_bytes = tree_bytes(state)
        gen = torch.Generator(device=DEVICE).manual_seed(29)
        batches = [make_batch(cfg, TRAIN_BATCH, seq, gen, device=DEVICE,
                              frontend_len=front)
                   for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_up
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        times, losses, norms = [], [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        launches = check_launches(
            f"{arch} training", **expected_train_launches(cfg, TRAIN_STEPS))
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(all(math.isfinite(x) for x in losses + norms),
              f"{arch} training: loss {losses} / grad norm {norms}")
        check(1.0 < losses[0] < 3 * math.log(cfg.vocab),
              f"{arch} training: first loss {losses[0]} is not near "
              f"ln(vocab) = {math.log(cfg.vocab)}")
        median = sorted(times)[len(times) // 2]
        records.append({
            "config": cfg.name, "layers": cfg.n_layers,
            "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "dtype": cfg.compute_dtype,
            "remat": cfg.remat, "params": n_params, "batch": TRAIN_BATCH,
            "seq": seq, "frontend": front, "setup_seconds": setup_s,
            "step_seconds": times, "step_median_s": median,
            "tok_per_s": TRAIN_BATCH * seq / median, "losses": losses,
            "grad_norms": norms, "launches": launches, "peak_mem_gb": peak,
            "state_bytes": state_bytes})
        del state, step, batches
        gc.collect()
        torch.cuda.empty_cache()
    return cut_steps, records


# ---------------------------------------------------------------------------
# The paper's serving experiments on the port (phases 30-32)
# ---------------------------------------------------------------------------

# exp3 at full width (phase 30): the reference's configs (replicas, clients
# a replica), each client 8 requests of one homogeneous 64-token prompt, 32
# new tokens each
EXP3_CONFIGS = ((1, 2), (2, 2), (4, 2))
EXP3_TRAFFIC = dict(reqs_per_client=8, prompt_len=64, new_tokens=32)
# phase 31: a token of the three f32 engines may differ only where the
# kernel-free oracle's top-two gap is under this
PAGED_GAP_TOL = 1e-5


def phase_exp3(torch, configs, get_model, exp3):
    """Phase 30: ``benchmarks_torch.bench_inference_scaling.run_config`` with
    llama3.2-3b at its full config (bf16, random weights from seed 0, one
    weight set every replica serves) and phase 8's engine, at exp3's
    configs and traffic shape.  Each config: every request back with its
    32 tokens, every replica served, the per-replica counts summing to the
    requests, the paged kernel launched n_layers x the replicas' decode
    steps and no other kernel.  The scaling efficiency tps(n) / (n tps(1))
    is measured, not gated."""
    cfg = configs.get_config(MAIN_PATH_ARCH)
    params = get_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(0),
                                 cfg, device=DEVICE)
    # one untimed request first, so no config pays a first call
    exp3.run_config(1, 1, reqs_per_client=1, prompt_len=EXP3_TRAFFIC[
        "prompt_len"], new_tokens=2, device=DEVICE, cfg=cfg, params=params,
        **MAIN_PATH_ENGINE)
    rows = []
    for n, cpc in EXP3_CONFIGS:
        where = f"exp3 x{n}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        r = exp3.run_config(n, cpc, **EXP3_TRAFFIC, device=DEVICE, cfg=cfg,
                            params=params, **MAIN_PATH_ENGINE)
        launches = check_launches(
            where, paged_decode_attention=cfg.n_layers * r["decode_steps"])[
            "paged_decode_attention"]
        want = n * cpc * EXP3_TRAFFIC["reqs_per_client"]
        per = r["per_replica_requests"]
        check(r["requests"] == want and sum(per) == want and len(per) == n,
              f"{where}: {r['requests']} requests, per replica {per}, "
              f"expected {want} over {n}")
        check(min(per) >= 1, f"{where}: a replica served nothing: {per}")
        check(r["generated_tokens"] == want * EXP3_TRAFFIC["new_tokens"],
              f"{where}: a request came back short "
              f"({r['generated_tokens']} tokens)")
        check(launches > 0, f"{where}: no decode step ran")
        r.update(paged_launches=launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        rows.append(r)
        gc.collect()
        torch.cuda.empty_cache()
    one = rows[0]
    for r in rows:
        r["scaling_efficiency"] = r["tokens_per_s"] / (
            r["replicas"] * one["tokens_per_s"])
        r["generated_scaling_efficiency"] = r["generated_tokens_per_s"] / (
            r["replicas"] * one["generated_tokens_per_s"])
    del params
    return {"config": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.compute_dtype,
            "shared_params": True, "engine": {
                k: list(v) if isinstance(v, tuple) else v
                for k, v in MAIN_PATH_ENGINE.items()},
            **EXP3_TRAFFIC, "rows": rows,
            "launches": sum(r["paged_launches"] for r in rows)}


def phase_paged_full(torch, configs, get_model, exp3):
    """Phase 31: ``paged_compare`` (``--paged``'s engines) with llama3.2-3b
    at its full config in float32 (one 12.8 GB weight set the three
    engines share) and the reference's traffic and pool (4 slots, max_len
    64, block 8, 12 branches off a 12-token stem, 6 new tokens, a 32-token
    warm burst).  The transcripts must be equal (a token may differ only
    where the kernel-free oracle's top-two gap is under PAGED_GAP_TOL,
    each such flip recorded with its gap); both paged rows show what
    ``check_paged`` demands; the paged kernel ran n_layers x the direct
    engine's decode steps, the contiguous kernel n_layers x the slot pool's
    and the gather engine's."""
    cfg = configs.get_config(MAIN_PATH_ARCH).scaled(
        param_dtype="float32", compute_dtype="float32")
    params = get_model(cfg).init(torch.Generator(device=DEVICE).manual_seed(0),
                                 cfg, device=DEVICE)
    zero_launches()
    rows, runs = exp3.paged_compare(device=DEVICE, cfg=cfg, params=params)
    steps = {name: run["engine"].stats.decode_steps
             for name, run in runs.items()}
    launches = check_launches(
        "paged compare", paged_decode_attention=cfg.n_layers * steps["paged"],
        decode_attention=cfg.n_layers * (steps["monolithic"]
                                         + steps["paged_gather"]))
    check(all(v > 0 for v in steps.values()),
          f"paged compare: decode steps {steps}")
    by = {r["engine"]: r for r in rows}
    check(by["paged_gather"]["decode_mode"] == "gather"
          and by["paged"]["decode_mode"] == "direct",
          "paged compare: rows mislabel their decode mode")
    for name in ("paged_gather", "paged"):
        r = by[name]
        check(r["peak_concurrent"] > r["max_num_seqs"]
              and r["shared_block_peak"] > 0 and r["cow_copies"] > 0
              and r["reserved_blocks"] == 0
              and 0 <= r["free_blocks"] <= r["num_blocks"],
              f"paged compare {name}: {r}")
    flips = {}
    if not rows[0]["tokens_match"]:
        memo = {}
        for name, run in runs.items():
            flips[name] = teacher_forced(
                torch, get_model, cfg, params, run["prompts"], run["outs"],
                f"paged compare {name}", memo, gap_tol=PAGED_GAP_TOL)
    out = {"config": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": "float32", "shared_params": True,
           "rows": rows, "decode_steps": steps,
           "launches": {k: v for k, v in launches.items() if v},
           "tokens_match": rows[0]["tokens_match"], "flips": flips,
           "direct_decode_tokens_per_s": by["paged"]["decode_tokens_per_s"],
           "gather_decode_tokens_per_s":
           by["paged_gather"]["decode_tokens_per_s"]}
    del runs, params
    return out


# the reference's CI bench smokes (.github/workflows/ci.yml) that touch the
# card, on the port, as (label, module and arguments, checker mode or
# None); each runs with --device cuda
CI_SMOKES = (
    ("paged", ("benchmarks_torch.bench_inference_scaling", "--paged",
               "--json"), "paged"),
    ("specdecode", ("benchmarks_torch.bench_inference_scaling",
                    "--speculative", "--json"), "specdecode"),
    ("disagg", ("benchmarks_torch.bench_inference_scaling", "--disagg",
                "--json"), "disagg"),
    ("affinity", ("benchmarks_torch.bench_routing", "--affinity",
                  "--replicas", "4", "--sessions", "6", "--turns", "6",
                  "--requests", "32", "--repeats", "1", "--json"),
     "affinity"),
    ("replica_sweep", ("benchmarks_torch.bench_routing", "--replicas", "1",
                       "2", "4", "--requests", "48"), None),
    ("qos", ("benchmarks_torch.bench_agentic", "--qos", "--json"), "qos"),
    ("kernels_suite", ("benchmarks_torch.run", "--only", "kernels"), None),
)
# the checker's gates that compare two timings (benchmarks/
# check_bench_json.py): a failure of one of these is a finding on the card,
# reported with its ratio, not a failure of the phase
TIMING_GATES = (
    "SLO step p95 blew the target",
    "direct paged decode slower than the gather round-trip",
    "disaggregation did not improve TTFT p95 by >= 1.2x",
    "disaggregation did not improve ITL p95 by >= 1.2x",
    "speculative decode did not pay for its draft",
    "disabled speculation degraded below vanilla",
    "QoS failed to isolate the high class",
    "QoS starved the low class",
)


def timing_ratios(mode, rows):
    """Each timing gate of ``mode``'s rows: (gate, measured ratio, the
    checker's threshold, 'min' or 'max')."""
    if mode == "paged":
        by = {r.get("engine"): r for r in rows}
        return [("direct / gather decode tokens/s",
                 by["paged"]["decode_tokens_per_s"]
                 / by["paged_gather"]["decode_tokens_per_s"], 0.9, "min")]
    if mode == "disagg":
        dis = next(r for r in rows if r.get("mode") == "disagg")
        return [("TTFT p95 speedup", dis["ttft_speedup"], 1.2, "min"),
                ("ITL p95 speedup", dis["itl_speedup"], 1.2, "min")]
    if mode == "specdecode":
        by = {r["stream"]: r for r in rows}
        return [("high-acceptance speedup",
                 by["high_acceptance"]["speedup_vs_vanilla"], 1.3, "min"),
                ("low-acceptance speedup",
                 by["low_acceptance"]["speedup_vs_vanilla"], 0.9, "min")]
    if mode == "qos":
        by = {r["phase"]: r for r in rows}
        return [("high p95 QoS / baseline",
                 by["qos"]["high_p95_s"] / by["baseline_high"]["high_p95_s"],
                 1.3, "max"),
                ("low throughput QoS / no QoS",
                 by["qos"]["low_throughput_per_s"]
                 / by["no_qos"]["low_throughput_per_s"], 0.8, "min")]
    return []


def unreached_checks(mode, rows):
    """The invariants the checker tests after a timing gate, which it never
    reaches when that gate fails: disagg's fallback row, spec-decode's
    disabled low-acceptance stream, the QoS counters and the paged
    service's telemetry.  -> the violated ones."""
    bad = []
    if mode == "disagg":
        fb = [r for r in rows if r.get("scenario") == "disagg_fallback"]
        if not (len(fb) == 1 and fb[0]["recomputes"] >= 1
                and fb[0]["completed"] == fb[0]["exports"] + 1
                and fb[0]["tokens_match"] is True):
            bad.append(f"disagg_fallback row {fb}")
    if mode == "specdecode":
        lo = [r for r in rows if r["stream"] == "low_acceptance"]
        if lo[0]["enabled"] is not False:
            bad.append(f"low_acceptance stream still enabled: {lo[0]}")
    if mode == "qos":
        qc = next(r for r in rows if r["phase"] == "qos")["qos_counters"]
        if not (isinstance(qc, dict) and qc.get("reporting_replicas", 0) >= 1
                and qc.get("engine_preemptions", 0)
                == qc.get("engine_preempt_resumes", 0)):
            bad.append(f"QoS counters {qc}")
    if mode == "paged":
        for r in rows:
            tel = r.get("block_telemetry")
            if r.get("scenario") == "paged_service" and not (
                    isinstance(tel, dict)
                    and 0 <= tel["free_blocks"] <= tel["total_blocks"]
                    and tel.get("reporting_replicas", 0) >= 1):
                bad.append(f"paged service telemetry {tel}")
    return bad


def phase_ci_smokes(out_dir):
    """Phase 32: each of ``CI_SMOKES`` as a subprocess on the card, its JSON
    checked by the reference's checker, unmodified, as a subprocess
    (``python benchmarks/check_bench_json.py <mode> <file>``).  The phase
    fails on a smoke that exits non-zero, on any checker failure but one
    of ``TIMING_GATES``, on any row with ``tokens_match`` false, and, when
    a timing gate stopped the checker, on an invariant it never reached
    (``unreached_checks``).  Every mode's timing ratios are printed beside
    their thresholds."""
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    results = {}
    for label, args, mode in CI_SMOKES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args, "--device",
                               DEVICE], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"smoke {label} exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        res = {"args": list(args), "seconds": seconds}
        if mode is None:
            res["stdout_tail"] = proc.stdout.strip().splitlines()[-12:]
            results[label] = res
            print(f"[smoke] {label}: exit 0 in {seconds:.1f} s", flush=True)
            continue
        path = os.path.join(out_dir, f"{label}.json")
        with open(path, "w") as f:
            f.write(proc.stdout)
        rows = json.loads(proc.stdout)
        chk = subprocess.run(
            [sys.executable, os.path.join("benchmarks", "check_bench_json.py"),
             mode, path], cwd=ROOT, capture_output=True, text=True,
            timeout=120)
        message = (chk.stdout + chk.stderr).strip()
        gate = next((g for g in TIMING_GATES if g in message), None)
        ratios = [{"gate": g, "ratio": x, "threshold": t, "kind": k,
                   "ok": x >= t if k == "min" else x <= t}
                  for g, x, t, k in timing_ratios(mode, rows)]
        verdict = ("ok" if chk.returncode == 0 else
                   "timing gate" if gate is not None else "FAIL")
        print(f"[check-bench-json] {label}: {verdict}", flush=True)
        if chk.returncode:
            print(message, flush=True)
        for r in ratios:
            print(f"[timing] {label}: {r['gate']} {r['ratio']:.4f} "
                  f"({r['kind']} {r['threshold']})", flush=True)
        check(chk.returncode == 0 or gate is not None,
              f"smoke {label}: the checker failed: {message}")
        unreached = unreached_checks(mode, rows) if gate is not None else []
        check(not unreached, f"smoke {label}: {unreached}")
        mismatched = [r for r in rows if r.get("tokens_match") is False]
        check(not mismatched, f"smoke {label}: tokens_match false in "
                              f"{mismatched}")
        res.update(mode=mode, checker_rc=chk.returncode,
                   checker=message, timing_gate=gate, ratios=ratios,
                   rows=len(rows))
        results[label] = res
    return results


# ---------------------------------------------------------------------------
# The launch tooling against the card (phases 33-34)
# ---------------------------------------------------------------------------

# the training steps that phases 16, 25 and 29 time, (arch, seq) at batch
# TRAIN_BATCH (internvl2-1b's 256 patches and whisper-small's 1500 frames
# are the configs' and the dry-run's own)
DRYRUN_STEPS = (("llama3.2-3b", TRAIN_SEQ), ("rwkv6-1.6b", TRAIN_SEQ),
                ("zamba2-2.7b", TRAIN_SEQ), ("internvl2-1b", TRAIN_SEQ),
                ("whisper-small", WHISPER_TEXT_CTX))
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun_chip.json")
# the train cells the worker also counts on both production meshes
DRYRUN_MESH_ARCHS = ("llama3.2-3b", "nemotron-4-340b")


def tree_bytes(state):
    """Bytes of the card's storages of a train state (the optimizer's step
    counter lies on the CPU), as the dry-run's ``specs.tree_bytes``."""
    from repro_torch.launch import specs

    return specs.tree_bytes(state, DEVICE)


def train_tcfg(seq):
    """The train config of phases 16, 25, 29 and 33 at ``seq``."""
    from repro_torch.training import optim, train

    return train.TrainConfig(
        global_batch=TRAIN_BATCH, seq_len=seq,
        optimizer=optim.OptimizerConfig(lr=3e-4, warmup_steps=1,
                                        decay_steps=100))


def loss_and_grads(api, cfg, params, batch):
    """The loss (detached) and every parameter's gradient."""
    import torch
    from repro_torch.training import optim

    loss, _ = api.loss(params, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss,
                                              optim.tree_leaves(params))


def dryrun_worker(path):
    """Phases 33-34's counting on ``meta``, in a process of its own (main()
    starts it after the build with the card hidden, so it runs on the CPU
    beside the card's phases): llama3.2-3b's four ``SHAPES`` cells through
    ``dryrun.run_cell``; each training step that phases 16, 25 and 29 time,
    at their shapes; and llama3.2-3b's loss and gradient at TRAIN_BATCH x
    TRAIN_SEQ under remat none, full and dots (phase 34) -> JSON at
    ``path``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import cost, dryrun, specs
    from repro_torch.models import get_model

    torch.set_num_threads(1)
    t_all = time.perf_counter()
    out = {"cells": [], "steps": {}, "remat": {}}
    for shape in specs.SHAPES:
        t0 = time.perf_counter()
        try:
            rec = dryrun.run_cell(MAIN_PATH_ARCH, shape)
        except Exception as e:  # noqa: BLE001 — phase 33 reports it
            rec = {"arch": MAIN_PATH_ARCH, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
        rec["seconds"] = time.perf_counter() - t0
        out["cells"].append(rec)
    for arch, seq in DRYRUN_STEPS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        fn, args = dryrun.build_train(get_model(cfg), cfg, train_tcfg(seq))
        counted = cost.analyze(fn, *args)
        out["steps"][arch] = {
            "seq": seq, "memory": dryrun.memory_summary(args, counted),
            "roofline": dryrun.roofline_from(
                counted, cfg, tokens=TRAIN_BATCH * seq, kind="train",
                seq=seq),
            "kernels": counted["kernels"],
            "seconds": time.perf_counter() - t0}
    out["mesh_cells"] = []
    for arch in DRYRUN_MESH_ARCHS:
        for multi_pod in (False, True):
            t0 = time.perf_counter()
            try:
                rec = dryrun.run_cell(arch, "train_4k", multi_pod=multi_pod)
            except Exception as e:  # noqa: BLE001 — phase 33 reports it
                rec = {"arch": arch, "shape": "train_4k",
                       "multi_pod": multi_pod, "status": "error",
                       "error": f"{type(e).__name__}: {e}"}
            rec["seconds"] = time.perf_counter() - t0
            out["mesh_cells"].append(rec)
    for remat in ("none", "full", "dots"):
        cfg = get_config(MAIN_PATH_ARCH, remat=remat)
        api = get_model(cfg)
        counter = cost.run(
            lambda p, b: loss_and_grads(api, cfg, p, b),
            specs.abstract_params(api, cfg)[0],
            specs.train_batch_specs(cfg, TRAIN_BATCH, TRAIN_SEQ))[1]
        out["remat"][remat] = {
            "flops": counter.flops, "bytes": counter.bytes,
            "mm_flops": sum(counter.by_op[op][1]
                            for op in ("aten.mm", "aten.addmm")),
            "peak_bytes": counter.peak,
            "flash_calls": counter.kernels["flash_attention"][0]}
    out["seconds"] = time.perf_counter() - t_all
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def start_dryrun_worker():
    """``chip_smoke.py --dryrun-worker`` as a child process at low priority,
    CUDA hidden; killed at exit if it is still running."""
    os.makedirs(os.path.dirname(DRYRUN_OUT), exist_ok=True)
    if os.path.exists(DRYRUN_OUT):
        os.remove(DRYRUN_OUT)
    log = open(DRYRUN_OUT + ".log", "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-worker",
         DRYRUN_OUT], stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        preexec_fn=lambda: os.nice(10))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def phase_dryrun(torch, worker, measured):
    """Phase 33: the dry-run's records (the worker's) against the card.
    llama3.2-3b's four cells: ok, long_500k skipped, whether each fits
    this card.  Each training step of ``measured`` (arch -> its phase's
    record): the bound max(t_compute, t_memory) at most the fastest warm
    step, its share (bound / measured) and model-FLOP share (6 N D /
    (measured x peak)); the parameters' and AdamW state's bytes equal to
    what the card holds for them; the estimated peak beside the card's."""
    code = worker.wait(timeout=900)
    with open(DRYRUN_OUT + ".log") as f:
        tail = f.read()[-2000:]
    check(code == 0, f"dry-run worker exited {code}: {tail}")
    with open(DRYRUN_OUT) as f:
        data = json.load(f)
    cap = torch.cuda.mem_get_info()[1]
    cells = []
    for rec in data["cells"]:
        want = "skipped" if rec["shape"] == "long_500k" else "ok"
        check(rec["status"] == want, f"dry-run {MAIN_PATH_ARCH} x "
                                     f"{rec['shape']}: {rec}")
        row = {"shape": rec["shape"], "status": rec["status"],
               "seconds": rec["seconds"]}
        if want == "ok":
            rl, mem = rec["roofline"], rec["memory"]
            row.update({k: rl[k] for k in (
                "t_compute_s", "t_memory_s", "bottleneck",
                "flops_per_device", "bytes_per_device",
                "useful_flops_ratio")},
                argument_bytes=mem["argument_size_in_bytes"],
                est_live_bytes=mem["est_live_bytes"],
                fits_card=mem["est_live_bytes"] <= cap,
                kernels=rec["kernels"])
        cells.append(row)
    steps = []
    for arch, seq in DRYRUN_STEPS:
        d, m = data["steps"][arch], measured[arch]
        rl, mem = d["roofline"], d["memory"]
        warm = min(m["step_seconds"][1:])
        bound = max(rl["t_compute_s"], rl["t_memory_s"])
        check(bound <= warm, f"{arch} step: dry-run bound {bound} s > the "
                             f"measured {warm} s (work counted twice?)")
        state = mem["params_bytes"] + mem["opt_bytes"]
        check(state == m["state_bytes"],
              f"{arch}: dry-run parameters + AdamW state {state} B != "
              f"{m['state_bytes']} B on the card")
        steps.append({
            "config": arch, "batch": TRAIN_BATCH, "seq": seq,
            "measured_s": warm, "median_s": m["step_median_s"],
            "bound_s": bound, "bound_by": rl["bottleneck"],
            "t_compute_s": rl["t_compute_s"], "t_memory_s": rl["t_memory_s"],
            "share": bound / warm,
            "model_flops": rl["model_flops_total"],
            "model_flop_share": rl["model_flops_total"]
            / (warm * H100_BF16_FLOPS),
            "flops": rl["flops_per_device"], "bytes": rl["bytes_per_device"],
            "state_bytes": state, "est_live_gb": mem["est_live_bytes"] / 1e9,
            "peak_mem_gb": m["peak_mem_gb"], "kernels": d["kernels"],
            "count_seconds": d["seconds"]})
    mesh_cells = []
    for rec in data["mesh_cells"]:
        n = 512 if rec["multi_pod"] else 256
        where = (f"dry-run {rec['arch']} x train_4k x "
                 f"{'2x16x16' if rec['multi_pod'] else '16x16'}")
        check(rec["status"] == "ok", f"{where}: {rec}")
        rl = rec["roofline"]
        check(rec["n_chips"] == n and rl["collective_bytes_per_device"] > 0,
              f"{where}: n_chips {rec['n_chips']}, collective bytes "
              f"{rl['collective_bytes_per_device']}")
        mesh_cells.append({
            "arch": rec["arch"], "mesh": rec["mesh"], "n_chips": n,
            "microbatches": rec["microbatches"],
            **{k: rl[k] for k in (
                "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "useful_flops_ratio")},
            "collective_detail": rl["collective_detail"],
            "est_live_bytes_per_device":
            rec["memory"]["est_live_bytes_per_device"],
            "seconds": rec["seconds"]})
    return {"cells": cells, "steps": steps, "mesh_cells": mesh_cells,
            "device_bytes": cap, "worker_seconds": data["seconds"]}, \
        data["remat"]


def phase_remat_dots(torch, configs, get_model, make_batch, optim, counts):
    """Phase 34: llama3.2-3b at full width (bf16), one loss-and-gradient
    step at TRAIN_BATCH x TRAIN_SEQ on the same weights and batch under
    remat "full" and "dots": the losses equal, every gradient leaf within
    BF16_GRAD_TOL, the flash kernel launched twice a layer under both (its
    forward is recomputed, not saved); each one's time (warm) and peak
    memory above what was allocated before it.  Then the worker's counts
    (``counts``, on meta): dots below full by exactly full's recomputed
    mm FLOPs, and dots's mm FLOPs those of remat none (no mm recomputed)."""
    cfg = configs.get_config(MAIN_PATH_ARCH)
    api = get_model(cfg)
    params = api.init(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                      device=DEVICE)
    for p in optim.tree_leaves(params):
        p.requires_grad_(True)
    batch = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                       torch.Generator(device=DEVICE).manual_seed(34),
                       device=DEVICE)
    runs, rec = {}, {"config": cfg.name, "batch": TRAIN_BATCH,
                     "seq": TRAIN_SEQ, "dtype": cfg.compute_dtype}
    for remat in ("full", "dots"):
        c = cfg.scaled(remat=remat)
        loss_and_grads(api, c, params, batch)  # warm
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        runs[remat] = loss_and_grads(api, c, params, batch)
        torch.cuda.synchronize()
        rec[remat] = {
            "seconds": time.perf_counter() - t0,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "step_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "launches": check_launches(
                f"remat {remat}",
                flash_attention=2 * cfg.n_layers)["flash_attention"],
            "loss": float(runs[remat][0])}
    check(torch.equal(runs["full"][0], runs["dots"][0]),
          f"remat dots loss {rec['dots']['loss']} != full "
          f"{rec['full']['loss']}")
    worst = 0.0
    for g_dots, g_full in zip(runs["dots"][1], runs["full"][1]):
        err, ok = within(g_dots, g_full, (BF16_GRAD_TOL, BF16_GRAD_TOL))
        worst = max(worst, err)
        check(ok, f"remat dots gradient error {err}")
    rec["max_grad_err"] = worst
    none, full, dots = (counts[k] for k in ("none", "full", "dots"))
    check(dots["flops"] < full["flops"],
          f"counted FLOPs: dots {dots['flops']} not below full "
          f"{full['flops']}")
    check(full["flops"] - dots["flops"] == full["mm_flops"] - none["mm_flops"]
          and dots["mm_flops"] == none["mm_flops"],
          f"counted FLOPs: full - dots = {full['flops'] - dots['flops']}, "
          f"full's recomputed mm {full['mm_flops'] - none['mm_flops']}, "
          f"dots's mm {dots['mm_flops']} vs none's {none['mm_flops']}")
    check(full["flash_calls"] == dots["flash_calls"]
          == 2 * none["flash_calls"],
          f"counted flash calls {[c['flash_calls'] for c in counts.values()]}")
    rec["counted"] = counts
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Training under a mesh (phases 35-36)
# ---------------------------------------------------------------------------


def grad_errors(got, want):
    """(max |got - want|, |got - want| / |want|) of one gradient leaf, in
    float32 (0 for a leaf whose gradients are both 0)."""
    d = got.float() - want.float()
    norm, dn = float(want.float().norm()), float(d.norm())
    if not norm:
        return float(d.abs().max()), math.inf if dn else 0.0
    return float(d.abs().max()), dn / norm


def phase_mesh_one_card(torch, configs, get_model, make_batch, optim, train):
    """Phase 35: llama3.2-3b at full width with explicit TP, FSDP and SP on
    a 1 x 1 NCCL mesh of this card against the unsharded step (see the
    module doc)."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import nn

    t_up = time.perf_counter()
    cfg = configs.get_config(MAIN_PATH_ARCH).scaled(**MESH_TP)
    api = get_model(cfg)
    tcfg = train_tcfg(TRAIN_SEQ)
    rdv = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    mesh_lib.init_ranks(0, 1, mesh_lib.rendezvous_file(rdv), backend="nccl")
    try:
        mesh = mesh_lib.make_local_mesh(1, 1, device=DEVICE)
        params, axes = api.init(torch.Generator(device=DEVICE).manual_seed(0),
                                cfg, device=DEVICE, with_axes=True)
        for p in optim.tree_leaves(params):
            p.requires_grad_(True)
        batch = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                           torch.Generator(device=DEVICE).manual_seed(35),
                           device=DEVICE)
        zero_launches()
        loss0, grads0 = loss_and_grads(api, cfg, params, batch)
        want = 2 * cfg.n_layers
        launches0 = check_launches("unsharded step",
                                   flash_attention=want)["flash_attention"]
        state_sh = train.state_shardings(axes, tcfg.optimizer, mesh, cfg=cfg)
        batch_sh = train.batch_shardings(cfg, mesh)
        placed = train._place_tree(params, state_sh["params"])
        for p in optim.tree_leaves(placed):
            p.requires_grad_(True)
        pbatch = train._place_tree(batch, batch_sh)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_up
        zero_launches()
        t0 = time.perf_counter()
        with nn.mesh_context(mesh):  # the step's own loss and gradient
            loss1, _, grads1 = train.microbatch_grads(api, cfg, placed,
                                                      pbatch, mesh)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        launches1 = check_launches("sharded step (1 x 1)",
                                   flash_attention=want)["flash_attention"]
        loss_err = abs(float(loss1) - float(loss0)) / abs(float(loss0))
        check(loss_err <= MESH_LOSS_TOL, f"sharded loss {float(loss1)} vs "
                                         f"{float(loss0)}")
        errs = {str(path): grad_errors(g1.full_tensor(), g0)
                for (path, _), g0, g1 in zip(optim.named_leaves(params),
                                             grads0, grads1)}
        worst = max(e[0] for e in errs.values())
        worst_rel = max(e[1] for e in errs.values())
        bad = {k: e for k, e in errs.items()
               if e[0] > MESH_GRAD_ATOL or e[1] > MESH_GRAD_REL_NORM}
        check(not bad, f"sharded gradients (max abs, relative norm) past "
                       f"({MESH_GRAD_ATOL}, {MESH_GRAD_REL_NORM}): {bad}")
        del grads0, grads1, params
        gc.collect()
        torch.cuda.empty_cache()
        state = train.place_state(
            {"params": placed, "opt": optim.adamw_init(placed,
                                                       tcfg.optimizer)},
            state_sh)
        step = train.place_train_step(
            train.make_train_step(api, cfg, tcfg, mesh), state_sh, batch_sh)
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        zero_launches()
        for _ in range(2):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        check_launches("sharded steps (1 x 1)", flash_attention=2 * want)
        check(all(math.isfinite(x) for x in losses),
              f"sharded steps: losses {losses}")
        rec = {"config": cfg.name, "mesh": {"data": 1, "model": 1},
               "backend": "nccl", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
               "flags": sorted(MESH_TP), "setup_seconds": setup_s,
               "loss_unsharded": float(loss0), "loss_sharded": float(loss1),
               "loss_rel_err": loss_err, "max_grad_err": worst,
               "max_grad_rel_norm": worst_rel,
               "launches_unsharded": launches0, "launches": launches1,
               "grad_seconds": grad_s, "step_seconds": times,
               "step_losses": losses,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state, step, placed
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_full_width(torch, rank, mesh, zero, counts):
    """Phase 36's full-width case on one rank: llama3.2-3b cut to
    ``MESH_FULL_LAYERS`` layers with TP, FSDP and SP, bf16, TRAIN_BATCH x
    TRAIN_SEQ, the sharded loss and gradient (``train.microbatch_grads``,
    the step's own).  Rank 0 first runs the one-rank loss and gradient on
    the same weights and batch and holds each gathered gradient leaf to
    it.  The flash kernel's input shapes are recorded as it launches."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import get_model, make_batch, nn
    from repro_torch.training import optim, train

    cfg = configs.get_config(MAIN_PATH_ARCH).scaled(
        n_layers=MESH_FULL_LAYERS, **MESH_TP)
    api = get_model(cfg)
    params, axes = api.init(torch.Generator(device=DEVICE).manual_seed(0),
                            cfg, device=DEVICE, with_axes=True)
    batch = make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ,
                       torch.Generator(device=DEVICE).manual_seed(36),
                       device=DEVICE)
    rec = {"config": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "head_dim": cfg.head_dim, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "dtype": cfg.param_dtype, "flags": sorted(MESH_TP)}
    grads0 = None
    if rank == 0:
        one = optim.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params)
        zero()
        loss0, _, grads0 = train.microbatch_grads(api, cfg, one, batch)
        torch.cuda.synchronize()
        rec["launches_one_rank"] = counts()
        rec["loss_one_rank"] = float(loss0)
        del one
    state_sh = train.state_shardings(axes, optim.OptimizerConfig(), mesh,
                                     cfg=cfg)
    placed = train._place_tree(params, state_sh["params"])
    for p in optim.tree_leaves(placed):
        p.requires_grad_(True)
    pbatch = train._place_tree(batch, train.batch_shardings(cfg, mesh))
    del params
    shapes = set()
    launch = fa._launch

    def spy(q, k, v):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return launch(q, k, v)

    dist.barrier()
    fa._launch = spy
    try:
        zero()
        t0 = time.perf_counter()
        with nn.mesh_context(mesh):
            loss1, _, grads1 = train.microbatch_grads(api, cfg, placed,
                                                      pbatch, mesh)
        torch.cuda.synchronize()
        rec["grad_seconds"] = time.perf_counter() - t0
        rec["launches"] = counts()
    finally:
        fa._launch = launch
    rec["flash_shapes"] = sorted(shapes)
    rec["loss"] = float(loss1)
    rec["local_device"] = str(optim.tree_leaves(placed)[0].to_local().device)
    errs = {}
    for i, ((path, _), g) in enumerate(zip(optim.named_leaves(placed),
                                           grads1)):
        full = g.full_tensor()
        if grads0 is not None:
            errs[str(path)] = grad_errors(full, grads0[i])
        del full
    if errs:
        rec["max_grad_err"] = max(e[0] for e in errs.values())
        rec["max_grad_rel_norm"] = max(e[1] for e in errs.values())
        rec["grad_errors"] = errs
    return rec


def mesh_rank(rank, rdv, out_dir):
    """One of phase 36's ranks (``torch.multiprocessing`` spawns it): every
    case of ``MESH_CASES`` on the 2 x 2 mesh, each against the one-rank
    step it also runs; its records to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import get_model, make_batch
    from repro_torch.training import optim, train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    counters = {"flash_attention": (fa, "launches"),
                "ssd": (ssd_ops, "launches"), "wkv6": (wkv_ops, "launches")}

    def zero():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    out = {"rank": rank, "cases": []}
    mesh_lib.init_ranks(rank, MESH_WORLD, mesh_lib.rendezvous_file(rdv),
                        backend="gloo")
    mesh_lib.stage_all_gather_through_host()
    try:
        mesh = mesh_lib.make_local_mesh(2, 2, device=DEVICE)
        for arch, over in MESH_CASES:
            rec = {"config": arch}
            try:
                cfg = configs.get_smoke_config(arch)
                if over == "nodrop":
                    cfg = cfg.scaled(capacity_factor=cfg.n_experts
                                     / cfg.top_k)
                else:
                    cfg = cfg.scaled(**over)
                api = get_model(cfg)
                opt = optim.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                            decay_steps=10, eps=1e-3)
                tcfg = train.TrainConfig(global_batch=MESH_BATCH,
                                         seq_len=MESH_SEQ, optimizer=opt)
                params, axes = api.init(
                    torch.Generator(device=DEVICE).manual_seed(0), cfg,
                    device=DEVICE, with_axes=True)
                batch = make_batch(cfg, MESH_BATCH, MESH_SEQ,
                                   torch.Generator(device=DEVICE
                                                   ).manual_seed(36),
                                   device=DEVICE)
                one = optim.tree_map(
                    lambda t: t.detach().clone().requires_grad_(True),
                    params)
                one_state = {"params": one, "opt": optim.adamw_init(one, opt)}
                zero()
                one_state, m0 = train.make_train_step(api, cfg, tcfg)(
                    one_state, batch)
                torch.cuda.synchronize()
                want = counts()
                state_sh = train.state_shardings(axes, opt, mesh, cfg=cfg)
                state = train.place_state(
                    {"params": params, "opt": optim.adamw_init(params, opt)},
                    state_sh)
                step = train.place_train_step(
                    train.make_train_step(api, cfg, tcfg, mesh), state_sh,
                    train.batch_shardings(cfg, mesh))
                mesh_lib.STAGED.clear()
                zero()
                t0 = time.perf_counter()
                state, m1 = step(state, batch)
                torch.cuda.synchronize()
                rec["step_seconds"] = time.perf_counter() - t0
                rec["launches"], rec["launches_one_rank"] = counts(), want
                rec["staged"] = dict(mesh_lib.STAGED)
                rec["loss_one_rank"] = float(m0["loss"])
                rec["loss"] = float(m1["loss"])
                worst = 0.0
                for (path, a), (_, b) in zip(
                        optim.named_leaves(state["params"]),
                        optim.named_leaves(one_state["params"])):
                    err, ok = within(a.full_tensor().detach(), b.detach(),
                                     (2e-5, 2e-3))
                    worst = max(worst, err)
                    if not ok:
                        rec.setdefault("param_mismatch", []).append(
                            [str(path), err])
                rec["max_param_err"] = worst
                rec["local_device"] = str(
                    optim.tree_leaves(state["params"])[0].to_local().device)
            except Exception:  # noqa: BLE001 — the parent fails the phase
                rec["error"] = traceback.format_exc()[-3000:]
            out["cases"].append(rec)
        try:
            out["full_width"] = mesh_full_width(torch, rank, mesh, zero,
                                                counts)
        except Exception:  # noqa: BLE001 — the parent fails the phase
            out["full_width"] = {"error": traceback.format_exc()[-3000:]}
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()


def phase_mesh_four_ranks(torch):
    """Phase 36: four gloo ranks sharing this card in a 2 x 2 mesh (see the
    module doc) -> each rank's records, checked."""
    import tempfile

    import torch.multiprocessing as mp

    d = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    mp.spawn(mesh_rank, args=(d, d), nprocs=MESH_WORLD, join=True)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(MESH_WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    cases = []
    for i, (arch, _) in enumerate(MESH_CASES):
        per = [rk["cases"][i] for rk in ranks]
        for r, rec in enumerate(per):
            where = f"{arch} rank {r} (2 x 2, four ranks on one card)"
            check("error" not in rec, f"{where}: {rec.get('error')}")
            check(rec["local_device"].startswith("cuda"),
                  f"{where}: shards on {rec['local_device']}")
            err = abs(rec["loss"] - rec["loss_one_rank"]) / abs(
                rec["loss_one_rank"])
            check(err <= 1e-5, f"{where}: loss {rec['loss']} vs one rank "
                               f"{rec['loss_one_rank']}")
            check("param_mismatch" not in rec,
                  f"{where}: parameters after the step "
                  f"{rec.get('param_mismatch')}")
            check(rec["launches"] == rec["launches_one_rank"]
                  and sum(rec["launches"].values()) > 0,
                  f"{where}: launches {rec['launches']} vs one rank "
                  f"{rec['launches_one_rank']}")
        cases.append({
            "config": arch, "loss": per[0]["loss"],
            "loss_one_rank": per[0]["loss_one_rank"],
            "max_param_err": max(r["max_param_err"] for r in per),
            "launches_by_rank": [r["launches"] for r in per],
            "launches_one_rank": per[0]["launches_one_rank"],
            "staged_by_rank": [r["staged"] for r in per],
            "step_seconds_by_rank": [r["step_seconds"] for r in per]})
    return {"mesh": {"data": 2, "model": 2}, "world": MESH_WORLD,
            "backend": "gloo, all-gather staged through host memory",
            "batch": MESH_BATCH, "seq": MESH_SEQ, "wall_seconds": wall,
            "cases": cases, "full_width": mesh_full_width_check(
                [rk["full_width"] for rk in ranks])}


def mesh_full_width_check(per):
    """Phase 36's full-width case, each rank's record checked -> the
    case's record: the loss and every gathered gradient leaf against the
    one-rank step's, each rank's launches equal to it, and the flash
    kernel on the local shard (batch and heads halved, K/V repeated)."""
    for r, rec in enumerate(per):
        where = f"full-width llama3.2-3b rank {r} (2 x 2, four ranks)"
        check("error" not in rec, f"{where}: {rec.get('error')}")
    first = per[0]
    want = first["launches_one_rank"]
    local = (TRAIN_BATCH // 2, TRAIN_SEQ, first["n_heads"] // 2,
             first["head_dim"])  # batch over "data", heads over "model"
    for r, rec in enumerate(per):
        where = f"full-width llama3.2-3b rank {r} (2 x 2, four ranks)"
        check(rec["local_device"].startswith("cuda"),
              f"{where}: shards on {rec['local_device']}")
        err = abs(rec["loss"] - first["loss_one_rank"]) / abs(
            first["loss_one_rank"])
        check(err <= MESH_LOSS_TOL,
              f"{where}: loss {rec['loss']} vs one rank "
              f"{first['loss_one_rank']}")
        check(rec["launches"] == want
              and want["flash_attention"] == 2 * MESH_FULL_LAYERS,
              f"{where}: launches {rec['launches']} vs one rank {want}")
        check(rec["flash_shapes"] == [[list(local), list(local)]],
              f"{where}: flash inputs {rec['flash_shapes']}, want q and k "
              f"{local}")
    bad = {k: e for k, e in first["grad_errors"].items()
           if e[0] > MESH_GRAD_ATOL or e[1] > MESH_GRAD_REL_NORM}
    check(not bad, f"full-width sharded gradients (max abs, relative norm) "
                   f"past ({MESH_GRAD_ATOL}, {MESH_GRAD_REL_NORM}): {bad}")
    out = {k: v for k, v in first.items()
           if k not in ("grad_errors", "launches", "grad_seconds")}
    out.update(launches_by_rank=[rec["launches"] for rec in per],
               grad_seconds_by_rank=[rec["grad_seconds"] for rec in per],
               loss_by_rank=[rec["loss"] for rec in per])
    return out


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
    from repro_torch.kernels.mamba2 import kernel as ssd_kernel
    from repro_torch.kernels.mamba2 import ops as ssd_ops
    from repro_torch.kernels.mamba2 import ref as ssd_ref
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model, make_batch, moe
    from repro_torch.serving import client, engine, kvcache
    from repro_torch.substrate import data
    from repro_torch.training import optim, train
    from repro_torch.backends import local, torchrt
    from repro_torch.substrate import simulation
    from benchmarks_torch import bench_agentic
    from benchmarks_torch import bench_inference_scaling as bench_exp3
    from benchmarks_torch import common as bench_common
    from benchmarks_torch import run as bench_run

    COUNTERS.update({
        "paged_decode_attention": (ops, "launches"),
        "decode_attention": (ops, "contiguous_launches"),
        "flash_attention": (fa, "launches"),
        "wkv6": (wkv_ops, "launches"),
        "ssd": (ssd_ops, "launches"),
    })

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

    # 1. build the five kernels' four sources at once, one nvcc each
    t0 = time.perf_counter()
    loaders = (kernel.load, fa_kernel.load, wkv_kernel.load, ssd_kernel.load)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(load) for load in loaders]:
            fut.result()
    flash_sass = sass_counts(build.build_log["flash_attention"]["path"])
    wkv_sass = sass_counts(build.build_log["wkv6"]["path"])
    ssd_sass = sass_counts(build.build_log["ssd"]["path"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {
              "library": os.path.relpath(log["path"], ROOT),
              "seconds": log["seconds"],
              "entries": ptxas_entries(log["ptxas"])}
              for name, log in build.build_log.items()},
          "flash_sass": flash_sass, "wkv_sass": wkv_sass,
          "ssd_sass": ssd_sass})
    # phases 33-34's counting on meta: a CPU process beside the card's
    worker = start_dryrun_worker()

    # 2. paged decode kernel vs plain
    cases, edges, timing, worst = phase_kernel(torch, ops, ref, kernel)
    emit({"phase": "kernel", "cases": cases, "split_edges": edges,
          "timing": timing})

    # 3-5. contiguous decode, WKV6 and SSD kernels vs plain, with times
    dec_cases, dec_timing, dec_llama, dec_more, dec_worst = phase_decode(
        torch, ops, ref, kernel)
    emit({"phase": "decode_kernel", "cases": dec_cases,
          "timing": dec_timing, "timing_llama_heads": dec_llama,
          "timing_encdec_vlm": dec_more})
    wkv_cases, wkv_refused, wkv_timings, wkv_worst = phase_wkv(
        torch, wkv_ops, wkv_ref, wkv_kernel, wkv_sass)
    emit({"phase": "wkv_kernel", "sass": wkv_sass, "cases": wkv_cases,
          "refused": wkv_refused, "timings": wkv_timings})
    ssd_cases, ssd_refused, ssd_timings, ssd_worst = phase_ssd(
        torch, ssd_ops, ssd_ref, ssd_kernel, ssd_sass)
    emit({"phase": "ssd_kernel", "sass": ssd_sass, "cases": ssd_cases,
          "refused": ssd_refused, "timings": ssd_timings})
    gc.collect()
    torch.cuda.empty_cache()

    # 6. model on the card, f32
    emit({"phase": "model", **phase_model(torch, configs, get_model,
                                          engine)})

    # 7. the launcher end to end
    emit({"phase": "launcher", "runs": phase_launcher(serve, configs)})

    # 8. the serving main path at a real model's full width
    main_path = phase_main_path(torch, configs, core, client)
    emit({"phase": "main_path", **main_path})
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the state-carrying families and the dense slot pool on the card,
    # f32, against a recurrent oracle that runs no kernel
    emit({"phase": "state_model", "models": phase_state_model(
        torch, configs, get_model, engine),
        "zamba2_forward": phase_hybrid_forward(torch, configs, get_model)})

    # 10-11. slot-pool serving of rwkv6-1.6b and zamba2-2.7b at full width
    state_paths = {}
    for arch in STATE_ARCHS:
        state_paths[arch] = phase_state_serving(torch, configs, core, client,
                                                arch)
        emit({"phase": "state_serving", **state_paths[arch]})
        gc.collect()
        torch.cuda.empty_cache()

    # 12. flash kernel vs plain, with the gradient
    flash_cases, flash_worst = phase_flash(torch, fa, fa_ref)
    emit({"phase": "flash", "cases": flash_cases})

    # 13. flash timing at the training shape and at zamba2's
    flash_timings = phase_flash_timing(torch, fa_kernel, fa, fa_ref,
                                       flash_sass)
    flash_timing = flash_timings["llama3.2-3b"]
    emit({"phase": "flash_timing", "sass": flash_sass, **flash_timings})
    gc.collect()
    torch.cuda.empty_cache()

    # 14. one train step on the card vs the CPU; 30 steps on the card
    emit({"phase": "train_step", **phase_train_step(
        torch, configs, get_model, optim, train, data)})

    # 15. the trainer launcher
    emit({"phase": "train_launcher",
          "runs": phase_train_launcher(launch_train, configs)})
    gc.collect()
    torch.cuda.empty_cache()

    # 16. the training main path at a real model's full width
    train_path = phase_train_main_path(torch, optim)
    emit({"phase": "train_main_path", **train_path})
    gc.collect()
    torch.cuda.empty_cache()

    # 17. the MoE model on the card, f32, against the kernel-free oracle in
    # both paged decode modes; the capacity-overflow check
    moe_model, moe_cfg, moe_params = phase_moe_model(
        torch, configs, get_model, engine, moe)
    emit({"phase": "moe_model", **moe_model})

    # 18. speculative decoding, f32 and exact, on phase 17's target
    emit({"phase": "spec_f32", **phase_spec_f32(
        torch, get_model, engine, moe_cfg, moe_params)})
    del moe_params
    gc.collect()
    torch.cuda.empty_cache()

    # 19. MoE serving at full width, bf16: 2 replicas sharing one
    # parameter set; then one engine's decode step and MoE layer timed
    moe_full = configs.get_config(MOE_ARCH)
    moe_params = get_model(moe_full).init(
        torch.Generator(device=DEVICE).manual_seed(0), moe_full,
        device=DEVICE)
    moe_path = phase_main_path(torch, configs, core, client, moe_full,
                               moe_params)
    gc.collect()
    torch.cuda.empty_cache()
    moe_path["timing"] = moe_decode_timing(torch, engine, moe, moe_full,
                                           moe_params)
    emit({"phase": "moe_serving", **moe_path})

    # 20. speculative decoding at full width, bf16
    emit({"phase": "spec_bf16", **phase_spec_bf16(
        torch, engine, moe_full, moe_params)})
    del moe_params
    gc.collect()
    torch.cuda.empty_cache()

    # 21. the prefill->decode handoff and preemption, f32 and exact
    emit({"phase": "disagg_exact", **phase_disagg_exact(
        torch, configs, get_model, engine, client, kvcache)})
    gc.collect()
    torch.cuda.empty_cache()

    # 22. disaggregated serving of llama3.2-3b at full width; QoS
    emit({"phase": "disagg_serving", **phase_disagg_serving(
        torch, configs, core, client, engine, get_model)})
    gc.collect()
    torch.cuda.empty_cache()

    # 23. the scans' gradients at the full configs' shapes
    emit({"phase": "scan_grads", "cases": phase_scan_grads(
        torch, wkv_ops, wkv_ref, ssd_ops, ssd_ref)})
    gc.collect()
    torch.cuda.empty_cache()

    # 24. rwkv6 and zamba2 gradients and one step, card vs CPU, f32
    emit({"phase": "state_train_step", "models": phase_state_train_step(
        torch, configs, get_model, optim, train)})

    # 25. rwkv6-1.6b and zamba2-2.7b training at full width
    state_train = {}
    for arch in STATE_TRAIN_ARCHS:
        state_train[arch] = phase_state_train_full(
            torch, configs, get_model, optim, train, data, arch)
        emit({"phase": "state_train_full", **state_train[arch]})

    # 26. the workflow payloads, the compute backend, the agents and the
    # port's benchmark suites on the card
    workflows = phase_workflows(torch, configs, get_model, core, simulation,
                                torchrt, local, bench_agentic, bench_run,
                                bench_common)
    emit({"phase": "workflows", **workflows})
    gc.collect()
    torch.cuda.empty_cache()

    # 27. whisper-small and internvl2-1b in f32 on the card: the slot
    # engine against a kernel-free oracle; whisper at its 1500-frame audio
    # context with the decode kernel against without it
    emit({"phase": "encdec_vlm_model", "models": phase_encdec_vlm_model(
        torch, configs, get_model, engine, kvcache, ops, ref)})

    # 28. slot-pool serving of whisper-small and internvl2-1b at full width
    encdec_vlm_paths = {}
    for arch in ENCDEC_VLM_ARCHS:
        encdec_vlm_paths[arch] = phase_state_serving(
            torch, configs, core, client, arch,
            engine=ENCDEC_VLM_ENGINE[arch])
        emit({"phase": "encdec_vlm_serving", **encdec_vlm_paths[arch]})
        gc.collect()
        torch.cuda.empty_cache()

    # 29. one cut step card vs CPU, then training at full width
    cut_steps, encdec_vlm_train = phase_encdec_vlm_train(
        torch, configs, get_model, optim, train, make_batch)
    emit({"phase": "encdec_vlm_train", "cut_steps": cut_steps,
          "full": encdec_vlm_train})
    gc.collect()
    torch.cuda.empty_cache()

    # 30. exp3 at full width: 1, 2 and 4 replicas of llama3.2-3b
    exp3_path = phase_exp3(torch, configs, get_model, bench_exp3)
    emit({"phase": "exp3", **exp3_path})
    gc.collect()
    torch.cuda.empty_cache()

    # 31. --paged's three engines at full width, f32
    paged_full = phase_paged_full(torch, configs, get_model, bench_exp3)
    emit({"phase": "paged_full", **paged_full})
    gc.collect()
    torch.cuda.empty_cache()

    # 32. the reference's CI smokes on the port, judged by its checker
    emit({"phase": "ci_smokes", "smokes": phase_ci_smokes(
        os.path.join(ROOT, "build", "ci_smokes"))})

    # 33. the dry-run's bounds against the training steps the card timed
    whisper_train, internvl_train = encdec_vlm_train
    dry, remat_counts = phase_dryrun(torch, worker, {
        MAIN_PATH_ARCH: train_path, **state_train,
        "whisper-small": whisper_train, "internvl2-1b": internvl_train})
    emit({"phase": "dryrun", **dry})

    # 34. remat "dots" against "full" at llama3.2-3b's full width
    emit({"phase": "remat_dots", **phase_remat_dots(
        torch, configs, get_model, make_batch, optim, remat_counts)})

    # 35. the sharded step on a 1 x 1 mesh of this card, full width
    mesh_one = phase_mesh_one_card(torch, configs, get_model, make_batch,
                                   optim, train)
    emit({"phase": "mesh_one_card", **mesh_one})

    # 36. four gloo ranks sharing this card in a 2 x 2 mesh
    mesh_four = phase_mesh_four_ranks(torch)
    emit({"phase": "mesh_four_ranks", **mesh_four})
    four = {c["config"]: c["launches_by_rank"] for c in mesh_four["cases"]}

    decode_src = ("src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu")
    rwkv, zamba = (state_paths[arch] for arch in STATE_ARCHS)

    rwkv_train, zamba_train = (state_train[a] for a in STATE_TRAIN_ARCHS)
    whisper, internvl = (encdec_vlm_paths[a] for a in ENCDEC_VLM_ARCHS)
    agents = workflows["agents"]["launches"]
    by_path = {  # launches on each path this script drives at full width
        "paged_decode_attention": {
            "main_path": main_path["launches"], "agent_population": agents,
            "exp3": exp3_path["launches"],
            "paged_compare_f32":
            paged_full["launches"]["paged_decode_attention"]},
        "decode_attention": {
            "zamba2_serving": zamba["launches"]["decode_attention"],
            "paged_compare_f32": paged_full["launches"]["decode_attention"],
            "whisper_serving": whisper["launches"]["decode_attention"],
            "internvl_serving": internvl["launches"]["decode_attention"]},
        "flash_attention": {"train_main_path": train_path["launches"],
                            "sharded_train_1x1": mesh_one["launches"],
                            "sharded_train_2x2_by_rank": {
                                a: [r["flash_attention"] for r in four[a]]
                                for a in four},
                            "sharded_train_2x2_full_width_by_rank": [
                                r["flash_attention"] for r in
                                mesh_four["full_width"]["launches_by_rank"]],
                            "zamba2_training":
                            zamba_train["launches"]["flash_attention"],
                            "whisper_training":
                            whisper_train["launches"]["flash_attention"],
                            "internvl_training":
                            internvl_train["launches"]["flash_attention"]},
        "ssd": {"zamba2_serving": zamba["launches"]["ssd"],
                "zamba2_training": zamba_train["launches"]["ssd"],
                "sharded_train_2x2_by_rank": [
                    r["ssd"] for r in four["zamba2-2.7b"]]},
        "wkv6": {"rwkv6_serving": rwkv["launches"]["wkv6"],
                 "rwkv6_training": rwkv_train["launches"]["wkv6"],
                 "sharded_train_2x2_by_rank": [
                     r["wkv6"] for r in four["rwkv6-1.6b"]]},
    }

    def line(name, source, replaces, launches, err, t):
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": t["kernel_ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "launches_by_path": by_path[name]}
        if "graph_ms" in t:  # device time replayed from a CUDA graph
            rec.update(graph_ms=t["graph_ms"],
                       library_graph_ms=t.get("library_graph_ms"))
        return rec

    emit({"kernels": [
        line("paged_decode_attention", decode_src,
             "src/repro/kernels/decode_attention/kernel.py:147",
             main_path["launches"], worst, timing),
        line("decode_attention", decode_src,
             "src/repro/kernels/decode_attention/kernel.py:74",
             zamba["launches"]["decode_attention"], dec_worst, dec_timing),
        line("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:70",
             train_path["launches"],
             max([flash_worst] + [t["max_err"]
                                  for t in flash_timings.values()]),
             flash_timing),
        line("ssd", "src/repro_torch/kernels/mamba2/csrc/ssd.cu",
             "src/repro/kernels/mamba2/kernel.py:61",
             zamba["launches"]["ssd"], ssd_worst, ssd_timings[0]),
        line("wkv6", "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6/kernel.py:60",
             rwkv["launches"]["wkv6"],
             max([wkv_worst] + [t["max_err"] for t in wkv_timings]),
             wkv_timings[0]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-worker"]:
        sys.exit(dryrun_worker(sys.argv[2]))
    sys.exit(main())
