"""The hand-written CUDA kernels against their plain versions, on the card,
the scans' autograd Functions among them; one training step (dense, rwkv6,
zamba2, whisper-small and internvl2-1b, the last two with their logits
through prefill and decode), the slot engine, the MoE paged engine in both decode modes, a
speculative-decoding session, the prefill->decode handoff, a preempted
sequence's resume and the simulation payloads on the card against the
same work on the CPU, the plain target engine or a unified engine.

Needs a CUDA card and imports neither JAX nor the JAX package, so it runs
where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Elsewhere every test skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.mamba2 import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2 import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ref as wkv_ref  # noqa: E402

# WKV/SSD kernel vs plain in float32: 1e-4 relative (with the same floor),
# the reference's own limit for these scans (tests/test_kernels.py): exps
# and sums over a chunk taken in another order.  bf16 outputs are rounded
# to bf16 on both sides: 4e-3 plus one bf16 ulp (2^-7) of the value.
F32_SCAN_TOL = (1e-4, 1e-4)
BF16_TOL = (4e-3, 2.0 ** -7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _paged(seed, B, num_blocks, bs, mb, Hkv, G, D, lens, dtype):
    """Random stores, permuted tables of distinct blocks (null block 0
    past each length), on the card."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, Hkv * G, D).astype(np.float32)
    ks = rng.randn(num_blocks, bs, Hkv, D).astype(np.float32)
    vs = rng.randn(num_blocks, bs, Hkv, D).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_blocks))[:B * mb].reshape(B, mb)
    bt = bt.astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b in range(B):
        bt[b, -(-int(lens[b]) // bs):] = 0
    dt = getattr(torch, dtype)
    q, ks, vs = (torch.from_numpy(a).cuda().to(dt) for a in (q, ks, vs))
    return q, ks, vs, torch.from_numpy(bt).cuda(), torch.from_numpy(lens).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Hkv,G,D,atol,rtol", [
    ("float32", 4, 2, 32, 2e-5, 2e-5), ("float32", 8, 3, 128, 2e-5, 2e-5),
    ("bfloat16", 8, 3, 128, 4e-3, 2.0 ** -7),
    ("float32", 2, 3, 8, 2e-5, 2e-5), ("bfloat16", 2, 3, 8, 4e-3, 2.0 ** -7),
    ("float32", 2, 2, 16, 2e-5, 2e-5),
    ("bfloat16", 2, 2, 16, 4e-3, 2.0 ** -7),
    ("float32", 1, 7, 8, 2e-5, 2e-5), ("bfloat16", 2, 7, 64, 4e-3, 2.0 ** -7),
    ("float32", 8, 12, 192, 2e-5, 2e-5),
    ("bfloat16", 8, 12, 192, 4e-3, 2.0 ** -7)])
def test_cuda_kernel_matches_plain(cuda, dtype, Hkv, G, D, atol, rtol):
    """The paged decode kernel vs its plain version at the shapes of
    rhapsody-demo (f32), llama3.2-3b (f32 and bf16), nemotron-4-340b (G 12,
    D 192) and the smoke configs of llama3.2-3b (head_dim 8) and qwen3-8b
    (16); block-size edge
    lengths; relocating physical blocks changes no bit.  Both sides round
    bf16 outputs to bf16, so bf16 allows 4e-3 plus one bf16 ulp (2^-7) of
    the value."""
    bs, mb = 16, 6
    q, ks, vs, bt, lens = _paged(11, 6, 48, bs, mb, Hkv, G, D,
                                 [1, bs - 1, bs, bs + 1, mb * bs, 37], dtype)
    before = ops.launches
    out = ops.paged_decode_attention(q, ks, vs, bt, lens)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    B = q.shape[0]
    plain = ref.paged_decode_ref(q.reshape(B, Hkv, G, D), ks, vs, bt, lens)
    torch.testing.assert_close(out.float(), plain.reshape(out.shape).float(),
                               rtol=rtol, atol=atol)
    perm = torch.from_numpy(np.concatenate(
        [[0], 1 + np.random.RandomState(3).permutation(47)])).cuda()
    inv = torch.argsort(perm)
    moved = ops.paged_decode_attention(q, ks[inv].contiguous(),
                                       vs[inv].contiguous(),
                                       perm[bt.long()].to(torch.int32), lens)
    assert torch.equal(out, moved)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    q, ks, vs, bt, lens = _paged(1, 2, 9, 8, 4, 2, 2, 48, [3, 9], "float32")
    before = ops.launches
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode_attention(q, ks, vs, bt, lens)  # D = 48
    q, ks, vs, bt, lens = _paged(1, 2, 9, 8, 4, 2, 2, 96, [3, 9], "float32")
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode_attention(q, ks, vs, bt, lens)  # D = 96
    q, ks, vs, bt, lens = _paged(1, 2, 9, 8, 4, 1, 17, 64, [3, 9],
                                 "bfloat16")
    with pytest.raises(ValueError, match="query heads"):
        ops.paged_decode_attention(q, ks, vs, bt, lens)  # G = 17
    q, ks, vs, bt, lens = _paged(1, 2, 9, 8, 4, 2, 2, 32, [3, 9], "float16")
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, ks, vs, bt, lens)
    assert ops.launches == before


def _qkv(seed, B, S, Hq, Hkv, D, dtype):
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
                 .cuda().to(dt) for H in (Hq, Hkv, Hkv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Hq,Hkv,D,atol,rtol,gtol", [
    ("float32", 8, 4, 32, 2e-5, 2e-5, 1e-4),
    ("float32", 24, 8, 128, 2e-5, 2e-5, 1e-4),
    ("bfloat16", 24, 8, 128, 4e-3, 2.0 ** -7, 2e-2),
    ("bfloat16", 4, 2, 64, 4e-3, 2.0 ** -7, 2e-2),
    ("bfloat16", 8, 4, 32, 4e-3, 2.0 ** -7, 2e-2),
    ("float32", 32, 32, 80, 2e-5, 2e-5, 1e-4),
    ("bfloat16", 32, 32, 80, 4e-3, 2.0 ** -7, 2e-2),
    ("float32", 6, 2, 8, 2e-5, 2e-5, 1e-4),
    ("bfloat16", 6, 2, 8, 4e-3, 2.0 ** -7, 2e-2),
    ("float32", 4, 2, 16, 2e-5, 2e-5, 1e-4),
    ("bfloat16", 4, 2, 16, 4e-3, 2.0 ** -7, 2e-2),
    ("float32", 14, 2, 64, 2e-5, 2e-5, 1e-4),
    ("bfloat16", 14, 2, 64, 4e-3, 2.0 ** -7, 2e-2),
    ("float32", 24, 2, 192, 2e-5, 2e-5, 1e-4),
    ("bfloat16", 24, 2, 192, 4e-3, 2.0 ** -7, 2e-2)])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 200, 2048])
def test_cuda_flash_kernel_matches_plain(cuda, dtype, Hq, Hkv, D, atol, rtol,
                                         gtol, S):
    """The causal flash kernel's out and lse vs ``attention_fwd_ref`` on the
    same inputs (ragged S included), and the gradient of
    ``FlashAttention`` vs autograd of the plain version in float32."""
    q, k, v = _qkv(7, 2, S, Hq, Hkv, D, dtype)
    before = fa_ops.launches
    out, lse = fa_ops._launch(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    plain, plain_lse = fa_ref.attention_fwd_ref(q, k, v)
    torch.testing.assert_close(out.float(), plain.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, plain_lse, rtol=2e-5, atol=2e-5)
    dout = torch.randn(out.shape, generator=torch.Generator(
        device="cuda").manual_seed(1), device="cuda").to(out.dtype)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    fa_ops.FlashAttention.apply(qg, kg, vg).backward(dout)
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    fa_ref.attention_fwd_ref(q32, k32, v32)[0].backward(dout.float())
    for got, want in ((qg, q32), (kg, k32), (vg, v32)):
        torch.testing.assert_close(got.grad.float(), want.grad, rtol=gtol,
                                   atol=gtol)


@pytest.mark.cuda
def test_cuda_flash_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    before = fa_ops.launches
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(*_qkv(1, 1, 8, 4, 2, 48, "bfloat16"))
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(*_qkv(1, 1, 8, 4, 2, 96, "bfloat16"))
    with pytest.raises(TypeError):
        fa_ops.flash_attention(*_qkv(1, 1, 8, 4, 2, 32, "float16"))
    q, k, v = _qkv(1, 1, 8, 4, 2, 32, "bfloat16")
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q, k, v.transpose(2, 3).contiguous()
                               .transpose(2, 3))
    # a head stride of 36 bf16 (72 bytes): D contiguous, but no TMA row
    wide = _qkv(1, 1, 8, 4, 2, 36, "bfloat16")[0]
    with pytest.raises(ValueError, match="16 bytes"):
        fa_ops.flash_attention(wide[..., :32], k, v)
    assert fa_ops.launches == before


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu_step(cuda):
    """One float32 step of rhapsody-demo cut to 2 layers (its heads: 8/4,
    D 32) on the card (kernel) equals the same step on the CPU (plain
    version): loss within 1e-5 relative, parameters within rtol 2e-3, atol
    2e-5; the kernel ran 2 x n_layers times (remat recomputes each block's
    forward)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.training import optim
    from repro_torch.training.train import TrainConfig, init_state, \
        make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("rhapsody-demo").scaled(n_layers=2, vocab=512)
    api = get_model(cfg)
    # eps 1e-3: the first update g / (|g| + eps) is then linear in the
    # gradients below eps instead of their sign, which float32 sums taken
    # in another order on the card would flip
    opt = optim.OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                decay_steps=10)
    tcfg = TrainConfig(optimizer=opt)
    cpu, _ = init_state(torch.Generator().manual_seed(0), api, cfg, opt,
                        device="cpu")
    gpu = {"params": optim.tree_map(
        lambda t: t.detach().cuda().requires_grad_(), cpu["params"])}
    gpu["opt"] = optim.adamw_init(gpu["params"], opt)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (4, 33)).astype(
        np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = make_train_step(api, cfg, tcfg)
    _, m_cpu = step(cpu, batch)
    before = fa_ops.launches
    _, m_gpu = step(gpu, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert fa_ops.launches - before == 2 * cfg.n_layers
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= \
        1e-5 * abs(float(m_cpu["loss"]))
    for a, b in zip(optim.tree_leaves(gpu["params"]),
                    optim.tree_leaves(cpu["params"])):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=2e-3,
                                   atol=2e-5)


def _close(got, want, tol):
    atol, rtol = tol
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Hkv,G,D", [
    ("float32", 4, 2, 32), ("float32", 8, 3, 128), ("float32", 32, 1, 80),
    ("bfloat16", 8, 3, 128), ("bfloat16", 32, 1, 80), ("float32", 2, 3, 8),
    ("bfloat16", 2, 3, 8), ("float32", 2, 2, 16), ("bfloat16", 2, 2, 16),
    ("float32", 1, 7, 8), ("bfloat16", 1, 7, 8), ("float32", 2, 7, 64),
    ("bfloat16", 2, 7, 64), ("float32", 8, 12, 192),
    ("bfloat16", 8, 12, 192)])
def test_cuda_contiguous_decode_matches_plain(cuda, dtype, Hkv, G, D):
    """The contiguous flash-decode kernel vs ``ref.decode_ref`` on slot
    caches [B, S, Hkv, D] of an S that is no multiple of the tile, ragged
    lengths, and idle rows whose length is past S (the kernel clamps it,
    the plain version's mask admits every position); group 7 is
    internvl2-1b's (its smoke config at D 8, the full one at D 64), group
    12 at D 192 nemotron-4-340b's."""
    S = 77
    lens = [1, 31, 32, 33, S - 1, S, S + 1, S + 500]
    rng = np.random.RandomState(5)
    B = len(lens)
    dt = getattr(torch, dtype)
    q, kc, vc = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .cuda().to(dt) for shape in ((B, 1, Hkv * G, D),
                                              (B, S, Hkv, D),
                                              (B, S, Hkv, D)))
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = ops.contiguous_launches
    out = ops.decode_attention(q, kc, vc, ln)
    torch.cuda.synchronize()
    assert ops.contiguous_launches == before + 1
    plain = ref.decode_ref(q.reshape(B, Hkv, G, D), kc, vc, ln)
    _close(out, plain.reshape(out.shape),
           (2e-5, 2e-5) if dtype == "float32" else BF16_TOL)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_cross_decode_at_whisper_frames(cuda, dtype):
    """whisper-small's cross-attention decode: B 8, 12 kv heads of one
    query head each, D 64, over all 1500 cached frames (every row's length
    is S), as ``transformer.block_decode`` calls it."""
    B, Hkv, G, D, S = 8, 12, 1, 64, 1500
    rng = np.random.RandomState(9)
    dt = getattr(torch, dtype)
    q, kc, vc = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 .cuda().to(dt) for shape in ((B, 1, Hkv * G, D),
                                              (B, S, Hkv, D),
                                              (B, S, Hkv, D)))
    ln = torch.full((B,), S, dtype=torch.int32, device="cuda")
    before = ops.contiguous_launches
    out = ops.decode_attention(q, kc, vc, ln)
    torch.cuda.synchronize()
    assert ops.contiguous_launches == before + 1
    plain = ref.decode_ref(q.reshape(B, Hkv, G, D), kc, vc, ln)
    _close(out, plain.reshape(out.shape),
           (2e-5, 2e-5) if dtype == "float32" else BF16_TOL)


def _scan_inputs(seed, shapes, dtypes):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda().to(d)
            for s, d in zip(shapes, dtypes)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,T,H,hd,chunk", [
    ("float32", 2, 37, 4, 16, 8), ("float32", 1, 256, 32, 64, 32),
    ("bfloat16", 1, 256, 32, 64, 32), ("bfloat16", 2, 70, 4, 16, 8)])
def test_cuda_wkv_matches_plain(cuda, dtype, B, T, H, hd, chunk):
    """The WKV6 kernel vs ``ref.wkv_chunked_ref`` (on the same padded
    inputs): y and the final state, from a non-zero initial state, with a
    T that is no multiple of the chunk."""
    dt = getattr(torch, dtype)
    f32 = torch.float32
    r, k, v, lw, u, s0 = _scan_inputs(
        11, [(B, T, H, hd)] * 4 + [(H, hd), (B, H, hd, hd)],
        [dt, dt, dt, f32, f32, f32])
    r, k = r * 0.5, k * 0.5
    lw = -torch.exp(lw - 1.0)
    u, s0 = u * 0.1, s0 * 0.1
    before = wkv_ops.launches
    y, s = wkv_ops.wkv(r, k, v, lw, u, chunk=chunk, s0=s0)
    torch.cuda.synchronize()
    assert wkv_ops.launches == before + 1
    pad = -T % chunk
    padded = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
              for t in (r, k, v, lw)]
    py, ps = wkv_ref.wkv_chunked_ref(*padded, u, chunk, s0)
    _close(y, py[:, :T], F32_SCAN_TOL if dtype == "float32" else BF16_TOL)
    _close(s, ps, F32_SCAN_TOL)


def _wkv_inputs(seed, dtype, B, T, H, hd, s0_scale, strong):
    """chip_smoke.py's recipe: r/k/v 0.5 N(0, 1), lw = -exp(N(0, 1) - 1)
    or, ``strong``, -e^x for x uniform in [-3, 3] (a token can decay by
    e^-20), u 0.1 N(0, 1), s0 ``s0_scale`` N(0, 1) or None."""
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    shape = (B, T, H, hd)
    r, k, v = (torch.from_numpy(0.5 * rng.randn(*shape).astype(np.float32))
               .cuda().to(dt) for _ in range(3))
    x = (rng.uniform(-3.0, 3.0, shape) if strong
         else rng.randn(*shape) - 1.0)
    lw = torch.from_numpy(-np.exp(x).astype(np.float32)).cuda()
    u = torch.from_numpy(0.1 * rng.randn(H, hd).astype(np.float32)).cuda()
    s0 = (torch.from_numpy(s0_scale * rng.randn(B, H, hd, hd)
                           .astype(np.float32)).cuda() if s0_scale else None)
    return r, k, v, lw, u, s0


# the bf16 body's cases (B, T, H, hd, chunk, s0 scale, strong decay): T 1,
# 17, 20 and 24 as one chunk, T = L, 2L and 3L, s0 absent and set, the
# strong decay, head_dim 16, 32 and 64
WKV_BF16_CASES = [
    (1, 1, 32, 64, 32, 0.0, False), (1, 17, 32, 64, 32, 0.1, False),
    (1, 20, 32, 64, 32, 0.0, False), (1, 24, 8, 64, 32, 0.1, False),
    (1, 32, 32, 64, 32, 0.1, False), (1, 64, 32, 64, 32, 0.0, False),
    (1, 96, 32, 64, 32, 0.1, False), (1, 256, 32, 64, 32, 0.0, False),
    (1, 256, 32, 64, 32, 0.1, True), (2, 128, 32, 64, 32, 0.1, False),
    (2, 70, 4, 16, 8, 0.0, False), (1, 96, 8, 32, 32, 0.1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,chunk,s0_scale,strong", WKV_BF16_CASES)
def test_cuda_wkv_bf16_body_matches_plain(cuda, B, T, H, hd, chunk, s0_scale,
                                          strong):
    """The bf16 WKV6 body vs ``ref.wkv_chunked_ref`` on the same padded
    inputs: y within bf16's rounding, the final state within 1e-4, no
    non-finite value, one launch."""
    r, k, v, lw, u, s0 = _wkv_inputs(14, "bfloat16", B, T, H, hd, s0_scale,
                                     strong)
    before = wkv_ops.launches
    y, s = wkv_ops.wkv(r, k, v, lw, u, chunk=chunk, s0=s0)
    torch.cuda.synchronize()
    assert wkv_ops.launches == before + 1
    L = min(chunk, T)
    padded = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, -T % L))
              for t in (r, k, v, lw)]
    py, ps = wkv_ref.wkv_chunked_ref(*padded, u, L, s0)
    _close(y, py[:, :T], BF16_TOL)
    _close(s, ps, F32_SCAN_TOL)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())


@pytest.mark.cuda
def test_cuda_wkv_bf16_two_calls_bit_equal(cuda):
    r, k, v, lw, u, s0 = _wkv_inputs(15, "bfloat16", 1, 256, 32, 64, 0.1,
                                     False)
    y1, s1 = wkv_ops.wkv(r, k, v, lw, u, chunk=32, s0=s0)
    y2, s2 = wkv_ops.wkv(r, k, v, lw, u, chunk=32, s0=s0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,chunk,shift", [(24, 8, 0), (48, 8, 0),
                                            (128, 8, 0), (64, 64, 0),
                                            (64, 32, 1)])
def test_cuda_wkv_bf16_refuses_what_the_body_cannot_take(cuda, hd, chunk,
                                                         shift):
    """head_dim not 16, 32 or 64, a chunk over 32, or r not on a 16-byte
    boundary: ValueError before any launch is counted."""
    r, k, v, lw, u, _ = _wkv_inputs(16, "bfloat16", 1, 128, 2, hd, 0.0,
                                    False)
    if shift:  # a contiguous view one element past an aligned start
        flat = torch.empty(r.numel() + shift, dtype=r.dtype, device="cuda")
        r = flat[shift:].view(r.shape).copy_(r)
    before = wkv_ops.launches
    with pytest.raises(ValueError, match="WKV6 kernel"):
        wkv_ops.wkv(r, k, v, lw, u, chunk=chunk)
    assert wkv_ops.launches == before


# (dtype, B, T, H, P, N, chunk, h0 scale): float32 at smoke and full
# widths; bf16 at T 1, 17 and 37 as one chunk, T = L, 2L and 3L at L 128,
# a ragged chunk of 40 over five chunks, h0 absent and non-zero, and every
# template of the bf16 body: P 16, 32 and 64, each with N up to 64 and up
# to 128 ((N, P) = (16, 16), (32, 32), (64, 64), (96, 16), (128, 32),
# (128, 64))
SSD_CASES = [
    ("float32", 2, 64, 3, 8, 4, 16, 0.1),
    ("float32", 1, 37, 4, 16, 16, 37, 0.1),
    ("float32", 1, 384, 80, 64, 64, 128, 0.1),
    ("bfloat16", 1, 384, 80, 64, 64, 128, 0.1),
    ("bfloat16", 2, 96, 4, 16, 16, 16, 0.1),
    ("bfloat16", 1, 1, 80, 64, 64, 128, 0.0),
    ("bfloat16", 1, 17, 80, 64, 64, 128, 0.1),
    ("bfloat16", 1, 37, 80, 64, 64, 128, 0.0),
    ("bfloat16", 1, 128, 80, 64, 64, 128, 0.0),
    ("bfloat16", 1, 256, 80, 64, 64, 128, 0.1),
    ("bfloat16", 1, 384, 80, 64, 64, 128, 0.0),
    ("bfloat16", 1, 200, 4, 64, 64, 40, 0.1),
    ("bfloat16", 2, 128, 80, 64, 64, 128, 0.0),
    ("bfloat16", 1, 256, 8, 32, 32, 128, 0.1),
    ("bfloat16", 1, 128, 33, 16, 96, 128, 0.0),
    ("bfloat16", 2, 128, 40, 32, 128, 128, 0.1),
    ("bfloat16", 1, 256, 8, 64, 128, 128, 0.0)]


def _ssd_inputs(seed, dtype, B, T, H, P, N, h0_scale):
    dt = getattr(torch, dtype)
    f32 = torch.float32
    x, dts, A, Bm, Cm, h0 = _scan_inputs(
        seed, [(B, T, H, P), (B, T, H), (H,), (B, T, N), (B, T, N),
               (B, H, N, P)], [dt, f32, f32, dt, dt, f32])
    dts = torch.nn.functional.softplus(dts - 2.0)
    A = -torch.exp(A)
    return x, dts, A, Bm, Cm, h0 * h0_scale if h0_scale else None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,T,H,P,N,chunk,h0_scale", SSD_CASES)
def test_cuda_ssd_matches_plain(cuda, dtype, B, T, H, P, N, chunk, h0_scale):
    """The SSD kernel vs ``ref.ssd_chunked_ref``: y and the final state,
    with and without an initial state, chunks of any length up to 128 (a
    37-token prompt runs as one chunk of 37)."""
    x, dts, A, Bm, Cm, h0 = _ssd_inputs(12, dtype, B, T, H, P, N, h0_scale)
    before = ssd_ops.launches
    y, h = ssd_ops.ssd(x, dts, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    py, ph = ssd_ref.ssd_chunked_ref(x, dts, A, Bm, Cm, min(chunk, T), h0)
    _close(y, py, F32_SCAN_TOL if dtype == "float32" else BF16_TOL)
    _close(h, ph, F32_SCAN_TOL)
    assert bool(torch.isfinite(y).all())


@pytest.mark.cuda
def test_cuda_ssd_bf16_two_calls_bit_equal(cuda):
    """The bf16 body at zamba2-2.7b's prefill shape with an initial state:
    within the limits, and two calls on the same inputs bit-equal."""
    x, dts, A, Bm, Cm, h0 = _ssd_inputs(13, "bfloat16", 1, 384, 80, 64, 64,
                                        0.1)
    y1, h1 = ssd_ops.ssd(x, dts, A, Bm, Cm, chunk=128, h0=h0)
    y2, h2 = ssd_ops.ssd(x, dts, A, Bm, Cm, chunk=128, h0=h0)
    torch.cuda.synchronize()
    py, ph = ssd_ref.ssd_chunked_ref(x, dts, A, Bm, Cm, 128, h0)
    _close(y1, py, BF16_TOL)
    _close(h1, ph, F32_SCAN_TOL)
    assert torch.equal(y1, y2)
    assert torch.equal(h1, h2)


@pytest.mark.cuda
def test_cuda_scan_wrappers_reject_what_the_kernels_cannot_take(cuda):
    f32 = torch.float32
    x, dts, A, Bm, Cm = _scan_inputs(
        1, [(1, 256, 2, 8), (1, 256, 2), (2,), (1, 256, 4), (1, 256, 4)],
        [f32] * 5)
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="at most 128"):
        ssd_ops.ssd(x, dts, A, Bm, Cm, chunk=256)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_ops.ssd(x[:, :200].contiguous(), dts[:, :200].contiguous(), A,
                    Bm[:, :200].contiguous(), Cm[:, :200].contiguous(),
                    chunk=128)
    for P, N in ((64, 24), (24, 64), (64, 144), (128, 64), (48, 64)):
        xb, db, Ab, Bb, Cb, _ = _ssd_inputs(3, "bfloat16", 1, 16, 2, P, N,
                                            0.0)
        with pytest.raises(ValueError, match="bf16 SSD kernel takes"):
            ssd_ops.ssd(xb, db, Ab, Bb, Cb, chunk=16)
    assert ssd_ops.launches == before
    r, lw, u = _scan_inputs(2, [(1, 8, 2, 16), (1, 8, 2, 16), (2, 16)],
                            [torch.float16, f32, f32])
    before = wkv_ops.launches
    with pytest.raises(TypeError):
        wkv_ops.wkv(r, r, r, lw, u, chunk=8)
    assert wkv_ops.launches == before


@pytest.mark.cuda
def test_cuda_slot_engine_matches_cpu_run(cuda):
    """rhapsody-demo (f32) through the slot engine on the card (the
    contiguous decode kernel) and on the CPU (its plain version), same
    weights and prompts: identical greedy transcripts and counters; the
    kernel ran n_layers times per decode step, and the full slot's length
    ran past max_len on the way."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.training import optim

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("rhapsody-demo")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    card_params = optim.tree_map(lambda t: t.cuda(), params)
    rng = np.random.RandomState(1)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (3, 8, 9, 17, 30)]
    runs = []
    for device, p in (("cpu", params), ("cuda", card_params)):
        eng = InferenceEngine(cfg, p, device=device, paged=False,
                              max_num_seqs=2, max_num_batched_tokens=64,
                              max_len=40, prefill_buckets=(16, 32))
        before = ops.contiguous_launches
        uids = [eng.submit(q, max_new_tokens=6) for q in prompts]
        uids.append(eng.submit(prompts[0], max_new_tokens=45))
        done = eng.run()
        runs.append(([done[u].output for u in uids], eng.stats,
                     ops.contiguous_launches - before))
    (cpu_out, cpu_stats, cpu_launches), (out, stats, launches) = runs
    assert out == cpu_out
    assert cpu_launches == 0
    assert launches == cfg.n_layers * stats.decode_steps > 0
    for name in ("steps", "decode_steps", "prefill_tokens", "decode_tokens"):
        assert getattr(stats, name) == getattr(cpu_stats, name), name


def _split_lens(rows, splits, cap):
    """Lengths at the tile edges, at and around each split boundary, that
    leave late split ranks empty, and at and past the cache's end."""
    edges = {1, rows - 1, rows, rows + 1, rows * (splits - 1) + 1,
             cap - 1, cap, cap + 1, cap + 500}
    for k in (1, 2, 3):
        edges |= {k * rows * splits - 1, k * rows * splits,
                  k * rows * splits + 1}
    return sorted(n for n in edges if n >= 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 16, 32, 64, 80, 128])
def test_cuda_decode_split_edges_determinism_and_relocation(cuda, dtype, D):
    """Both decode entry points vs their plain versions where the split of
    the sequence across a cluster's blocks has its edges: one kv head of
    one sequence (plus two engine-style padding rows of length 1 with
    all-null tables), so the cache is split across the most blocks, at
    every length of ``_split_lens``; then zamba2's 8 x 32 (sequence, kv
    head) pairs, which take no split.  Two calls agree bit for bit, and
    relocating physical blocks changes no bit.  f32 within 2e-5, bf16
    within 4e-3 + 2^-7 x |plain| (the kernel's limits everywhere)."""
    from repro_torch.kernels.decode_attention import kernel

    dt = getattr(torch, dtype)
    tol = (2e-5, 2e-5) if dtype == "float32" else BF16_TOL
    rows = 16 if D * dt.itemsize >= 128 else 32  # positions a tile
    bs, mb = 16, 64
    cap = bs * mb
    rng = np.random.RandomState(D)
    for B, Hkv, G, pad in ((1, 1, 3, 2), (8, 32, 1, 0)):
        n = B + pad
        splits, _ = kernel.launch_shape(dt, n, Hkv, G, D, cap)
        if B == 1:
            assert splits > 1, "the small case must exercise the split"
        all_lens = _split_lens(rows, splits, cap)
        batches = ([[x] for x in all_lens] if B == 1 else
                   [all_lens[i:i + B] for i in range(0, len(all_lens) - B + 1,
                                                     B)])
        for lens in batches:
            num_blocks = B * mb + 1
            q = torch.from_numpy(rng.randn(n, 1, Hkv * G, D).astype(
                np.float32)).cuda().to(dt)
            ks, vs = (torch.from_numpy(rng.randn(
                num_blocks, bs, Hkv, D).astype(np.float32)).cuda().to(dt)
                for _ in range(2))
            bt = np.zeros((n, mb), np.int32)
            perm = rng.permutation(np.arange(1, num_blocks))
            for b, length in enumerate(lens):
                used = -(-min(length, cap) // bs)
                bt[b, :used] = perm[b * mb:b * mb + used]
            ln = torch.tensor(list(lens) + [1] * pad, dtype=torch.int32,
                              device="cuda")
            bt = torch.from_numpy(bt).cuda()
            out = ops.paged_decode_attention(q, ks, vs, bt, ln)
            again = ops.paged_decode_attention(q, ks, vs, bt, ln)
            plain = ref.paged_decode_ref(q.reshape(n, Hkv, G, D), ks, vs, bt,
                                         ln)
            _close(out, plain.reshape(out.shape), tol)
            assert torch.equal(out, again), f"paged {lens}: not deterministic"
            moved = torch.from_numpy(np.concatenate(
                [[0], 1 + rng.permutation(num_blocks - 1)])).cuda()
            inv = torch.argsort(moved)
            relocated = ops.paged_decode_attention(
                q, ks[inv].contiguous(), vs[inv].contiguous(),
                moved[bt.long()].to(torch.int32), ln)
            assert torch.equal(out, relocated), f"paged {lens}: relocation"
            # the same rows as contiguous caches of S = cap
            kc, vc = (ref.gather_kv(t, bt).contiguous() for t in (ks, vs))
            got = ops.decode_attention(q, kc, vc, ln)
            again = ops.decode_attention(q, kc, vc, ln)
            plain = ref.decode_ref(q.reshape(n, Hkv, G, D), kc, vc, ln)
            _close(got, plain.reshape(got.shape), tol)
            assert torch.equal(got, again), f"slot {lens}: not deterministic"


def _served(arch, argv, counter):
    """Run the serve launcher on the card; -> (its output, the counter's
    launches during the run)."""
    from repro_torch.launch import serve

    before = getattr(ops, counter)
    out = serve.main(["--arch", arch, "--requests", "8"] + argv)
    torch.cuda.synchronize()
    return out, getattr(ops, counter) - before


@pytest.mark.cuda
@pytest.mark.parametrize("arch,argv,counter", [
    ("llama3.2-3b", [], "launches"),
    ("qwen3-8b", [], "launches"),
    ("qwen3-8b", ["--no-paged"], "contiguous_launches"),
    ("deepseek-moe-16b", [], "launches")])
def test_cuda_serve_launcher_runs_smoke_archs(cuda, arch, argv, counter):
    """``repro_torch.launch.serve --arch <arch>`` on the card serves the
    arch's smoke config (head_dim 8 for llama3.2-3b, 16 for qwen3-8b and
    deepseek-moe-16b)
    through the paged pool (or the slot pool with ``--no-paged``): every
    request comes back whole, no replica failed, and the decode kernel ran
    n_layers times a decode step."""
    from repro_torch.configs import get_smoke_config

    out, launched = _served(arch, argv, counter)
    assert all(e is None for e in out["errors"]), out["errors"]
    assert len(out["results"]) == 8
    assert all(len(r["tokens"]) == 8 for r in out["results"])
    cfg = get_smoke_config(arch)
    assert launched == cfg.n_layers * out["decode_steps"] > 0


@pytest.mark.cuda
def test_cuda_train_launcher_runs_a_smoke_arch(cuda):
    """``repro_torch.launch.train --arch llama3.2-3b --steps 5`` on the
    card trains the smoke config (head_dim 8): finite losses, the flash
    kernel 2 x n_layers times a step (remat runs each forward again)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train

    before = fa_ops.launches
    out = train.main(["--arch", "llama3.2-3b", "--steps", "5"])
    torch.cuda.synchronize()
    cfg = get_smoke_config("llama3.2-3b")
    assert out["device"].startswith("cuda")
    assert len(out["losses"]) == 5
    assert all(np.isfinite(x) for x in out["losses"])
    assert fa_ops.launches - before == 2 * cfg.n_layers * 5


@pytest.mark.cuda
def test_cuda_train_launcher_runs_moe(cuda):
    """``--arch deepseek-moe-16b --steps 3``: the MoE smoke config's
    forward and loss on the card, the flash kernel 2 x n_layers a step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train

    before = fa_ops.launches
    out = train.main(["--arch", "deepseek-moe-16b", "--steps", "3"])
    torch.cuda.synchronize()
    cfg = get_smoke_config("deepseek-moe-16b")
    assert len(out["losses"]) == 3
    assert all(np.isfinite(x) for x in out["losses"])
    assert fa_ops.launches - before == 2 * cfg.n_layers * 3


def _moe_engines(mode, **kw):
    """The deepseek-moe-16b smoke config (f32) from one set of weights,
    as paged engines on the CPU and on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.training import optim

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("deepseek-moe-16b")
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    engine_kw = dict(max_num_seqs=4, max_num_batched_tokens=256, max_len=64,
                     prefill_buckets=(16, 32), paged=True, block_size=8,
                     paged_decode_mode=mode, **kw)
    return cfg, [InferenceEngine(cfg, p, device=d, **engine_kw)
                 for d, p in (("cpu", params),
                              ("cuda", optim.tree_map(lambda t: t.cuda(),
                                                      params)))]


def _launch_counts():
    return ops.launches, ops.contiguous_launches


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "gather"])
def test_cuda_moe_paged_engine_matches_cpu_run(cuda, mode):
    """The MoE paged engine on the card and on the CPU, same weights and
    prompts (lengths at the block edges): identical greedy transcripts and
    counters; ``direct`` launches the paged decode kernel n_layers times
    a decode step and ``gather`` the contiguous one, never the other."""
    cfg, engines = _moe_engines(mode)
    rng = np.random.RandomState(7)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (7, 8, 9, 15, 16, 17)]
    runs = []
    for eng in engines:
        before = _launch_counts()
        uids = [eng.submit(q, max_new_tokens=6) for q in prompts]
        done = eng.run()
        torch.cuda.synchronize()
        runs.append(([done[u].output for u in uids], eng.stats,
                     [a - b for a, b in zip(_launch_counts(), before)]))
    (cpu_out, cpu_stats, cpu_launches), (out, stats, launches) = runs
    assert out == cpu_out
    assert cpu_launches == [0, 0]
    want = cfg.n_layers * stats.decode_steps
    assert want > 0
    assert launches == ([want, 0] if mode == "direct" else [0, want])
    for name in ("decode_steps", "prefill_tokens", "decode_tokens"):
        assert getattr(stats, name) == getattr(cpu_stats, name), name


@pytest.mark.cuda
def test_cuda_spec_session_matches_plain_target(cuda):
    """A MoE target (smoke config, f32) with a same-config draft cut to
    its one dense layer, paged and paged, on the card: the transcripts of
    the plain target engine; the draft's paged decodes launch the kernel
    once a draft step, and the target, verifying through ``extend``,
    launches no decode kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import (InferenceEngine,
                                            SpecDecodeSession,
                                            make_engine_from_scratch)

    cfg, (_, target) = _moe_engines("direct")
    dcfg = get_smoke_config("deepseek-moe-16b").scaled(n_layers=1)
    draft = make_engine_from_scratch(dcfg, seed=1, device="cuda",
                                     paged=True, max_num_seqs=4, max_len=64,
                                     prefill_buckets=(16, 32), block_size=8)
    plain = InferenceEngine(cfg, target.params, device="cuda", paged=True,
                            max_num_seqs=4, max_num_batched_tokens=256,
                            max_len=64, prefill_buckets=(16, 32),
                            block_size=8)
    rng = np.random.RandomState(3)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (5, 9, 3, 7)]
    uids = [plain.submit(q, max_new_tokens=10) for q in prompts]
    done = plain.run()
    want = [done[u].output for u in uids]
    sess = SpecDecodeSession(target, draft, k=3)
    before = _launch_counts()
    uids = [sess.submit(q, max_new_tokens=10) for q in prompts]
    done = sess.run()
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_launch_counts(), before)]
    assert [done[u].output for u in uids] == want
    ss = sess.spec_stats()
    assert ss["proposed"] > 0 and 0.0 <= ss["acceptance_rate"] <= 1.0
    assert target.stats.decode_steps == 0
    assert launched == [dcfg.n_layers * draft.stats.steps, 0]


def _demo_engines(n, **kw):
    """rhapsody-demo (f32) paged engines on the card sharing one weight
    set drawn from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("rhapsody-demo")
    params = get_model(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                                 cfg, device="cuda")
    kw = dict(dict(max_num_seqs=4, max_num_batched_tokens=256, max_len=128,
                   prefill_buckets=(16, 32), paged=True, block_size=16), **kw)
    return cfg, [InferenceEngine(cfg, params, device="cuda", **kw)
                 for _ in range(n)]


@pytest.mark.cuda
def test_cuda_disagg_round_trip_bit_equal_and_token_identical(cuda):
    """A prefill engine on the card exports each sequence at its first
    token (host tensors), a decode engine imports it: the imported blocks,
    extracted again, equal the payload bit for bit; the transcripts equal
    a unified engine's; the prefill engine launches no decode kernel and
    the decode engine the paged one n_layers times a decode step."""
    from repro_torch.serving.kvcache import extract_blocks

    cfg, (pre, dec, uni) = _demo_engines(3)
    rng = np.random.RandomState(2)
    prompts = [list(map(int, rng.randint(1, cfg.vocab, size=n)))
               for n in (3, 16, 17, 40)]
    uids = [uni.submit(q, max_new_tokens=8) for q in prompts]
    done = uni.run()
    want = [done[u].output for u in uids]
    before = _launch_counts()
    puids = [pre.submit(q, max_new_tokens=8) for q in prompts]
    pays = {}
    while len(pays) < len(prompts):
        pre.step_prefill_only()
        for u in pre.exportable():
            pays[u] = pre.export_sequence(u)
    assert _launch_counts() == before and pre.stats.decode_steps == 0
    moved = []
    for u in puids:
        pay = pays[u]
        assert all(t.device.type == "cpu" for t in pay["leaves"].values())
        nuid = dec.import_sequence(pay)
        again = extract_blocks(dec.pool.cache, dec.running[nuid].table)
        assert all(torch.equal(again[k], v) for k, v in pay["leaves"].items())
        moved.append(nuid)
    done = dec.run()
    torch.cuda.synchronize()
    assert [done[u].output for u in moved] == want
    launched = [a - b for a, b in zip(_launch_counts(), before)]
    assert launched == [cfg.n_layers * dec.stats.decode_steps, 0]
    assert dec.stats.decode_steps > 0


@pytest.mark.cuda
def test_cuda_preempt_resume_token_identical(cuda):
    """A decoding sequence preempted on the card (its blocks retired to
    residency) resumes through a catch-up extend with the transcript of
    uninterrupted decode and its first-token stamp."""
    cfg, (eng, uni) = _demo_engines(2)
    prompts = [[5] * 12, [9] * 7, [4] * 20]
    uids = [uni.submit(q, max_new_tokens=10) for q in prompts]
    done = uni.run()
    want = [done[u].output for u in uids]
    uids = [eng.submit(q, max_new_tokens=10) for q in prompts]
    for _ in range(100):
        eng.step()
        req = eng.running.get(uids[0])
        if req is not None and len(req.output) >= 3:
            break
    stamp = eng.running[uids[0]].first_token_at
    assert eng.preempt_sequence(uids[0])
    done = eng.run()
    assert [done[u].output for u in uids] == want
    assert done[uids[0]].first_token_at == stamp
    assert eng.stats.preemptions == eng.stats.preempt_resumes == 1


def _scan_case(kind, dtype, s0_set):
    """Inputs of a ``wkv`` (T 37 in chunks of 8: padded) or ``ssd`` (T 48 in
    chunks of 16) call on the card, drawn with numpy."""
    rng = np.random.RandomState(23)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).cuda().to(dt)

    f32 = torch.float32
    if kind == "wkv":
        B, T, H, hd, L = 2, 37, 2, 16, 8
        args = [t(B, T, H, hd, scale=0.5), t(B, T, H, hd, scale=0.5),
                t(B, T, H, hd, scale=0.5),
                -torch.exp(t(B, T, H, hd, dt=f32) - 1.0),
                t(H, hd, scale=0.1, dt=f32)]
        s0 = t(B, H, hd, hd, scale=0.1, dt=f32) if s0_set else None
        return args, s0, L
    B, T, H, P, N, L = 2, 48, 4, 16, 16, 16
    args = [t(B, T, H, P), torch.nn.functional.softplus(
        t(B, T, H, dt=f32) - 2.0), -(1.0 + 15.0 * torch.rand(H).cuda()),
        t(B, T, N), t(B, T, N)]
    s0 = t(B, H, N, P, scale=0.1, dt=f32) if s0_set else None
    return args, s0, L


@pytest.mark.cuda
@pytest.mark.parametrize("s0_set", [False, True])
@pytest.mark.parametrize("dtype,gtol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("kind", ["wkv", "ssd"])
def test_cuda_scan_functions_carry_the_gradient(cuda, kind, dtype, gtol,
                                                s0_set):
    """On the card ``wkv`` and ``ssd`` launch their kernel once and return
    outputs with a ``grad_fn``; every input's gradient, under cotangents of
    both outputs, equals autograd of the plain version on float32 copies
    (1e-4 relative for f32 inputs, 2e-2 for bf16), in its input's
    dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, s0, L = _scan_case(kind, getattr(torch, dtype), s0_set)
    leaves = args + ([s0] if s0 is not None else [])
    mine = [a.clone().requires_grad_() for a in leaves]
    plain = [a.float().clone().requires_grad_() for a in leaves]
    st = (lambda xs: xs[5] if s0_set else None)
    if kind == "wkv":
        counter = wkv_ops
        before = counter.launches
        y, s = wkv_ops.wkv(*mine[:5], chunk=L, s0=st(mine))
        pad = -args[0].shape[1] % L
        py, ps = wkv_ref.wkv_chunked_ref(
            *[torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
              for a in plain[:4]], plain[4], L, st(plain))
        py = py[:, :args[0].shape[1]]
    else:
        counter = ssd_ops
        before = counter.launches
        y, s = ssd_ops.ssd(*mine[:5], chunk=L, h0=st(mine))
        py, ps = ssd_ref.ssd_chunked_ref(*plain[:5], L, st(plain))
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert y.grad_fn is not None and s.grad_fn is not None
    gen = torch.Generator(device="cuda").manual_seed(1)
    wy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    ws = torch.randn(s.shape, generator=gen, device="cuda")
    got = torch.autograd.grad((y, s), mine, (wy, ws))
    want = torch.autograd.grad((py, ps), plain, (wy.float(), ws))
    assert counter.launches == before + 1  # the backward launches nothing
    for g, w, x in zip(got, want, leaves):
        assert g.dtype == x.dtype
        torch.testing.assert_close(g.float(), w, rtol=gtol, atol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_cuda_state_family_gradient_and_step_match_cpu(cuda, arch):
    """The smoke config in float32: every gradient leaf of ``loss`` on the
    card (the scans' kernels forward, their Functions backward) equals the
    CPU's within 1e-4, and one AdamW step (eps 1e-3) the CPU's step within
    rtol 2e-3, atol 2e-5; the scan kernels ran 2 x n_layers times a pass
    (remat full reruns each checkpointed forward)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.training import optim
    from repro_torch.training.train import TrainConfig, init_state, \
        make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    opt = optim.OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                decay_steps=10)
    cpu, _ = init_state(torch.Generator().manual_seed(0), api, cfg, opt,
                        device="cpu")
    gpu = {"params": optim.tree_map(
        lambda t: t.detach().cuda().requires_grad_(), cpu["params"])}
    gpu["opt"] = optim.adamw_init(gpu["params"], opt)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 33)).astype(
        np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    counter = wkv_ops if cfg.family == "ssm" else ssd_ops
    g_cpu = torch.autograd.grad(api.loss(cpu["params"], batch, cfg)[0],
                                optim.tree_leaves(cpu["params"]))
    before = counter.launches
    g_gpu = torch.autograd.grad(api.loss(gpu["params"], gbatch, cfg)[0],
                                optim.tree_leaves(gpu["params"]))
    torch.cuda.synchronize()
    assert counter.launches - before == 2 * cfg.n_layers
    for a, b in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    step = make_train_step(api, cfg, TrainConfig(optimizer=opt))
    _, m_cpu = step(cpu, batch)
    _, m_gpu = step(gpu, gbatch)
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= \
        1e-5 * abs(float(m_cpu["loss"]))
    for a, b in zip(optim.tree_leaves(gpu["params"]),
                    optim.tree_leaves(cpu["params"])):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=2e-3,
                                   atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_cuda_train_launcher_runs_state_families(cuda, arch):
    """``--arch rwkv6-1.6b`` / ``--arch zamba2-2.7b --steps 3`` on the card:
    finite losses; WKV6 (rwkv6) or SSD (zamba2) 2 x n_layers a step, and
    for zamba2 the flash kernel 2 x n_layers / attn_every."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train

    cfg = get_smoke_config(arch)
    counters = {"wkv": (wkv_ops, wkv_ops.launches),
                "ssd": (ssd_ops, ssd_ops.launches),
                "flash": (fa_ops, fa_ops.launches)}
    out = train.main(["--arch", arch, "--steps", "3"])
    torch.cuda.synchronize()
    got = {k: mod.launches - before for k, (mod, before) in counters.items()}
    assert out["device"].startswith("cuda")
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    if cfg.family == "ssm":
        assert got == {"wkv": 2 * cfg.n_layers * 3, "ssd": 0, "flash": 0}
    else:
        assert got == {"wkv": 0, "ssd": 2 * cfg.n_layers * 3,
                       "flash": 2 * cfg.n_layers // cfg.attn_every * 3}


@pytest.mark.cuda
def test_cuda_payloads_and_backend_match_cpu(cuda):
    """The simulation payloads on the card equal their CPU runs from the
    same seed (heat within 1e-6, LJ and the surrogate within 1e-4
    relative); ``TorchBackend`` on the card completes a task only once its
    result is ready."""
    from repro_torch.backends.torchrt import TorchBackend
    from repro_torch.core.task import Task, TaskDescription
    from repro_torch.substrate import simulation as sim

    torch.backends.cuda.matmul.allow_tf32 = False
    np.testing.assert_allclose(sim.heat_stencil(seed=3, _ranks=4,
                                                device="cuda"),
                               sim.heat_stencil(seed=3, _ranks=4,
                                                device="cpu"),
                               rtol=0, atol=1e-6)
    for fn in (sim.lj_step, sim.surrogate_eval):
        np.testing.assert_allclose(fn(seed=3, device="cuda"),
                                   fn(seed=3, device="cpu"), rtol=1e-4,
                                   atol=1e-6)
    import threading

    done, seen = threading.Event(), []
    backend = TorchBackend().start(
        lambda task, res, err: (seen.append((res, err)), done.set()))
    try:
        x = torch.arange(1 << 20, device="cuda", dtype=torch.float32)
        backend.submit(Task(TaskDescription(fn=lambda: (x * x).sum())))
        assert done.wait(60)
    finally:
        backend.shutdown()
    (res, err), = seen
    assert err is None and res.device.type == "cuda"
    assert backend.device.type == "cuda"
    exact = float((x.double() ** 2).sum())
    assert abs(float(res) - exact) <= 1e-3 * exact


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_cuda_encdec_vlm_logits_and_step_match_cpu(cuda, arch):
    """The smoke config in float32, card vs CPU on the same weights and
    inputs (frontend embeddings included): ``prefill`` and three
    ``decode_step``s within 1e-4 (the contiguous decode kernel n_layers
    times a step, twice for whisper: self and cross attention), then
    every gradient leaf of ``loss`` within 1e-4 and one AdamW step (eps
    1e-3) within rtol 2e-3, atol 2e-5 (the flash kernel 2 x n_layers
    times a pass: the decoder's causal self-attention under remat)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model, make_batch
    from repro_torch.training import optim
    from repro_torch.training.train import TrainConfig, init_state, \
        make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    opt = optim.OptimizerConfig(lr=1e-3, eps=1e-3, warmup_steps=1,
                                decay_steps=10)
    cpu, _ = init_state(torch.Generator().manual_seed(0), api, cfg, opt,
                        device="cpu")
    gpu = {"params": optim.tree_map(
        lambda t: t.detach().cuda().requires_grad_(), cpu["params"])}
    gpu["opt"] = optim.adamw_init(gpu["params"], opt)
    batch = make_batch(cfg, 2, 16, torch.Generator().manual_seed(1),
                       device="cpu")
    gbatch = {k: v.cuda() for k, v in batch.items()}
    per_step = cfg.n_layers * (2 if cfg.family == "encdec" else 1)
    logits = []
    for params, b in ((cpu["params"], batch), (gpu["params"], gbatch)):
        with torch.no_grad():
            inputs = {k: v for k, v in b.items()
                      if k not in ("targets", "loss_mask")}
            cache, out = api.prefill(params, inputs, cfg, max_len=64)
            seq = [out]
            before = ops.contiguous_launches
            for _ in range(3):
                cache, out = api.decode(params, cache, out.argmax(-1), cfg)
                seq.append(out)
            launched = ops.contiguous_launches - before
        logits.append(torch.stack(seq).cpu())
    assert launched == 3 * per_step
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-4, atol=1e-4)
    g_cpu = torch.autograd.grad(api.loss(cpu["params"], batch, cfg)[0],
                                optim.tree_leaves(cpu["params"]))
    before = fa_ops.launches
    g_gpu = torch.autograd.grad(api.loss(gpu["params"], gbatch, cfg)[0],
                                optim.tree_leaves(gpu["params"]))
    torch.cuda.synchronize()
    assert fa_ops.launches - before == 2 * cfg.n_layers
    for a, b in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    step = make_train_step(api, cfg, TrainConfig(optimizer=opt))
    _, m_cpu = step(cpu, batch)
    _, m_gpu = step(gpu, gbatch)
    assert abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) <= \
        1e-5 * abs(float(m_cpu["loss"]))
    for a, b in zip(optim.tree_leaves(gpu["params"]),
                    optim.tree_leaves(cpu["params"])):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=2e-3,
                                   atol=2e-5)
