"""The port's paged KV pool against the JAX package's: the allocator's
conservation, refcounts and error paths; ``gather_block_view`` /
``scatter_block_writes`` / copy-on-write on the same numpy store (exact:
they only move data); ``extract_blocks`` / ``insert_blocks``, the
migration payload, in both directions."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import dense_cfg  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402


def _random_ops(alloc, ref, rng, n_ops=400):
    """Drive both allocators through the same random allocate/fork/free
    sequence; return the live reference multiset."""
    live: list = []
    for _ in range(n_ops):
        op = rng.randint(3)
        if op == 0:
            b, rb = alloc.allocate(), ref.allocate()
            assert b == rb
            if b is not None:
                live.append(b)
        elif op == 1 and live:
            b = live[rng.randint(len(live))]
            alloc.fork(b)
            ref.fork(b)
            live.append(b)
        elif op == 2 and live:
            b = live.pop(rng.randint(len(live)))
            assert alloc.free(b) == ref.free(b)
    return live


@pytest.mark.parametrize("seed", range(3))
def test_allocator_conservation_and_refcounts(seed):
    rng = np.random.RandomState(seed)
    alloc, ref = tkv.BlockAllocator(12), jkv.BlockAllocator(12)
    live = _random_ops(alloc, ref, rng)
    assert alloc._ref == ref._ref
    for b in range(1, 12):
        assert alloc.refcount(b) == live.count(b)
    assert alloc.n_live == len(set(live))
    assert alloc.n_free + alloc.n_live == alloc.capacity == 11
    assert alloc.block_savings() == len(live) - len(set(live))
    for b in list(live):
        alloc.free(b)
    assert alloc.n_free == alloc.capacity and alloc.block_savings() == 0


def test_allocator_error_paths():
    alloc = tkv.BlockAllocator(4)
    with pytest.raises(ValueError):
        tkv.BlockAllocator(1)  # no room for the null block + one real block
    b = alloc.allocate()
    alloc.free(b)
    with pytest.raises(ValueError):
        alloc.free(b)  # double free
    with pytest.raises(ValueError):
        alloc.fork(b)  # fork of an unallocated block
    with pytest.raises(ValueError):
        alloc.fork(tkv.NULL_BLOCK)  # the null block is never refcounted
    with pytest.raises(ValueError):
        alloc.free(99)  # out of range
    assert [alloc.allocate() for _ in range(4)] == [2, 3, 1, None]


def _stores(seed, L=2, N=10, bs=4, H=2, D=3):
    rng = np.random.RandomState(seed)
    k = rng.randn(L, N, bs, H, D).astype(np.float32)
    v = rng.randn(L, N, bs, H, D).astype(np.float32)
    jstore = {"scan": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                       "len": jnp.zeros((L, N), jnp.int32)}}
    tstore = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    return jstore, tstore


def test_gather_and_scatter_match_reference():
    jstore, tstore = _stores(0)
    bt = np.asarray([[3, 7, 2], [9, 1, 4]], np.int32)
    lens = np.asarray([6, 9], np.int32)
    jview = jkv.gather_block_view(jstore, jnp.asarray(bt), jnp.asarray(lens))
    tview = tkv.gather_block_view(tstore, torch.from_numpy(bt),
                                  torch.from_numpy(lens))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tview[name].numpy(),
                                      np.asarray(jview["scan"][name]))
    assert tview["len"].tolist() == lens.tolist()
    # write three new positions per sequence into the view, scatter back
    rng = np.random.RandomState(1)
    T = 3
    wpos = lens[:, None] + np.arange(T)[None, :]
    wphys = np.asarray([[bt[b, p // 4] for p in wpos[b]] for b in range(2)],
                       np.int32)
    woff = (wpos % 4).astype(np.int32)
    new = rng.randn(2, 2, T, 2, 3).astype(np.float32)  # [L, B, T, H, D]
    jk = np.asarray(jview["scan"]["k"]).copy()
    for b in range(2):
        jk[:, b, wpos[b]] = new[:, b]
        tview["k"][:, b, torch.from_numpy(wpos[b])] = torch.from_numpy(
            new[:, b])
    jview["scan"]["k"] = jnp.asarray(jk)
    jout = jkv.scatter_block_writes(jstore, jview, jnp.asarray(wphys),
                                    jnp.asarray(woff), jnp.asarray(wpos))
    tout = tkv.scatter_block_writes(tstore, tview, torch.from_numpy(wphys),
                                    torch.from_numpy(woff),
                                    torch.from_numpy(wpos))
    assert tout is tstore  # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(tstore[name].numpy(),
                                      np.asarray(jout["scan"][name]))


def test_pool_layout_and_copy_on_write():
    cfg = dense_cfg()
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    ref = jkv.PagedCachePool(cfg, num_blocks=9, block_size=8, max_len=32)
    pool = tkv.PagedCachePool(tcfg, num_blocks=9, block_size=8, max_len=32,
                              device="cpu")
    assert tuple(pool.cache["k"].shape) == tuple(
        ref.cache["scan"]["k"].shape)
    assert pool.max_blocks == ref.max_blocks == 4
    assert pool.n_free == ref.n_free == 8
    rng = np.random.RandomState(2)
    k = rng.randn(*pool.cache["k"].shape).astype(np.float32)
    pool.cache["k"] = torch.from_numpy(k.copy())
    ref.cache["scan"]["k"] = jnp.asarray(k)
    pool.copy_block(3, 5)
    ref.copy_block(3, 5)
    np.testing.assert_array_equal(pool.cache["k"].numpy(),
                                  np.asarray(ref.cache["scan"]["k"]))
    with pytest.raises(ValueError, match="num_blocks"):
        tkv.PagedCachePool(tcfg, num_blocks=4, block_size=8, max_len=64,
                           device="cpu")
    with pytest.raises(ValueError, match="paged"):
        tkv.PagedCachePool(tcfg.scaled(family="ssm"), num_blocks=8,
                           block_size=4, max_len=16, device="cpu")


def test_pools_default_to_the_card():
    """Like every other entry point of the port, both pools take the card
    unless the caller asks for the CPU: with no card, the default raises."""
    tcfg = ModelConfig(**dataclasses.asdict(dense_cfg()))
    if torch.cuda.is_available():
        paged = tkv.PagedCachePool(tcfg, num_blocks=9, block_size=8,
                                   max_len=32)
        slot = tkv.CachePool(tcfg, 2, 16)
        assert paged.cache["k"].is_cuda and slot.cache["k"].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.PagedCachePool(tcfg, num_blocks=9, block_size=8, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkv.CachePool(tcfg, 2, 16)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _fill(pool, rng):
    """Random cache contents (lengths 1..8) -> {path: ndarray}."""
    data = {}
    for path, leaf in _leaves(pool.cache):
        a = rng.randint(1, 9, size=leaf.shape) if path[-1] == "len" \
            else rng.randn(*leaf.shape)
        data[path] = a.astype(leaf.numpy().dtype)
        leaf.copy_(torch.from_numpy(data[path]))
    return data


def test_slot_pool_set_lens_and_reset_slot_match_reference():
    """``set_lens`` (many slots' lengths at once, the speculative rewind)
    and ``reset_slot`` on the same random cache as the reference's, exact:
    zamba2's cache, whose ``len`` is [G, B] (the reference's layout)."""
    from repro.configs import get_smoke_config

    cfg = get_smoke_config("zamba2-2.7b")
    ref = jkv.CachePool(cfg, 4, 16)
    pool = tkv.CachePool(ModelConfig(**dataclasses.asdict(cfg)), 4, 16,
                         device="cpu")
    data = _fill(pool, np.random.RandomState(0))

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return jnp.asarray(data[path], tree.dtype)

    ref.cache = build(ref.cache)
    for pl in (ref, pool):
        pl.set_lens({0: 5, 3: 11})
        pl.set_lens({})
        pl.reset_slot(1)
    want = dict(_leaves(ref.cache))
    got = dict(_leaves(pool.cache))
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(want[path], np.float32),
                                      err_msg=str(path))


def test_dense_slot_pool_set_lens_and_reset_slot():
    """The dense cache keeps one ``len`` [B] (the reference one a layer):
    ``set_lens`` sets the named slots only; ``reset_slot`` zeroes one
    slot's K, V and length and nothing else."""
    pool = tkv.CachePool(ModelConfig(**dataclasses.asdict(dense_cfg())), 4,
                         16, device="cpu")
    data = _fill(pool, np.random.RandomState(1))
    pool.set_lens({0: 5, 3: 11})
    pool.reset_slot(1)
    want_len = data[("len",)].copy()
    want_len[[0, 3]] = [5, 11]
    want_len[1] = 0
    assert pool.cache["len"].tolist() == want_len.tolist()
    for name in ("k", "v"):
        want = data[(name,)].copy()
        want[:, 1] = 0
        np.testing.assert_array_equal(pool.cache[name].numpy(), want)


def _ref_store(k, v, n_pre):
    """The reference's paged store over the same rows: the first ``n_pre``
    layers apart (an MoE model's dense layers), the rest stacked."""
    store = {"scan": {"k": jnp.asarray(k[n_pre:]), "v": jnp.asarray(v[n_pre:]),
                      "len": jnp.zeros((k.shape[0] - n_pre, k.shape[1]),
                                       jnp.int32)}}
    if n_pre:
        store["pre"] = {f"layer_{i}": {"k": jnp.asarray(k[i]),
                                       "v": jnp.asarray(v[i]),
                                       "len": jnp.zeros((k.shape[1],),
                                                        jnp.int32)}
                        for i in range(n_pre)}
    return store


@pytest.mark.parametrize("n_pre", [0, 1])
def test_extract_and_insert_blocks_match_reference(n_pre):
    """``extract_blocks`` gives the reference's payload (keys, shapes and
    values, the block dim in front, on the host); ``insert_blocks`` writes
    the port's payload or the reference's numpy one in place, and both
    packages' stores then agree; the null block is never a destination."""
    L, N, bs, H, D = 3, 10, 4, 2, 3
    rng = np.random.RandomState(3)
    k = rng.randn(L, N, bs, H, D).astype(np.float32)
    v = rng.randn(L, N, bs, H, D).astype(np.float32)
    src = [7, 2, 5]
    jpay = jkv.extract_blocks(_ref_store(k, v, n_pre), src)
    tpay = tkv.extract_blocks({"k": torch.from_numpy(k.copy()),
                               "v": torch.from_numpy(v.copy())}, src, n_pre)
    assert set(tpay) == set(jpay)
    for path, leaf in tpay.items():
        assert leaf.device.type == "cpu"
        np.testing.assert_array_equal(leaf.numpy(), jpay[path])
    dst = [9, 1, 4]
    zeros = np.zeros_like(k)
    jout = jkv.insert_blocks(_ref_store(zeros, zeros, n_pre), jpay, dst)
    want = np.zeros_like(k)
    want[n_pre:] = np.asarray(jout["scan"]["k"])
    for i in range(n_pre):
        want[i] = np.asarray(jout["pre"][f"layer_{i}"]["k"])
    for pay in (tpay, jpay):  # the port's payload and the reference's
        store = {"k": torch.zeros(L, N, bs, H, D),
                 "v": torch.zeros(L, N, bs, H, D)}
        keep = store["k"]
        assert tkv.insert_blocks(store, pay, dst) is store
        assert store["k"] is keep  # in place
        np.testing.assert_array_equal(store["k"].numpy(), want)
        np.testing.assert_array_equal(store["k"].numpy()[:, dst],
                                      k[:, src])
        np.testing.assert_array_equal(store["v"].numpy()[:, dst],
                                      v[:, src])
    with pytest.raises(ValueError, match="null block"):
        tkv.insert_blocks(store, tpay, [0, 1, 4])


def test_insert_blocks_takes_a_reference_bf16_payload():
    """A bf16 payload exported by the reference (numpy's bfloat16
    extension type) lands in a bf16 store with its bits unchanged; the
    port's own payload is a bf16 host tensor."""
    L, N, bs, H, D = 2, 6, 4, 2, 8
    rng = np.random.RandomState(4)
    k = rng.randn(L, N, bs, H, D).astype(np.float32)
    jk = jnp.asarray(k, jnp.bfloat16)
    jstore = {"scan": {"k": jk, "v": jk,
                       "len": jnp.zeros((L, N), jnp.int32)}}
    jpay = jkv.extract_blocks(jstore, [3, 5])
    tk = torch.tensor(np.asarray(jk.astype(jnp.float32))).bfloat16()
    store = {"k": torch.zeros(L, N, bs, H, D, dtype=torch.bfloat16),
             "v": torch.zeros(L, N, bs, H, D, dtype=torch.bfloat16)}
    tkv.insert_blocks(store, jpay, [1, 2])
    assert torch.equal(store["k"][:, [1, 2]], tk[:, [3, 5]])
    tpay = tkv.extract_blocks({"k": tk, "v": tk}, [3, 5])
    assert tpay[("scan", "k")].dtype == torch.bfloat16
    assert torch.equal(tpay[("scan", "k")].movedim(0, 1), tk[:, [3, 5]])
