"""The port's logical axes, sharding rules and mesh regions against the
JAX package.

* Every arch's axes tree (smoke and full config; the port's init on
  ``meta``, the reference's through its ``abstract_params``) equals the
  reference's, and ``make_specs`` under ``TRAIN_RULES`` and
  ``SERVE_RULES`` equals ``repro.launch.sharding.make_specs`` on both
  production meshes (the reference is handed a stub with ``axis_names``
  and ``shape``, all it reads).
* On a 2 x 2 ``("data", "model")`` mesh of four gloo processes on the CPU
  (one spawn for the module; ``tests/_torch_mesh_ranks.py``): each
  parameter's local shard has the shape its spec implies;
  ``linear_apply_tp`` column and row (with ``fsdp``, with ``seq_shard``),
  the model-sharded ``embedding_apply`` and ``_sharded_loglik`` equal
  their plain counterparts in value and gradient (1e-5); the host-staged
  all-gather equals gloo's.
* The reference's two single-device tests of ``tests/test_optimizations
  .py``, ported: padded heads are exact, and ``explicit_tp`` /
  ``fsdp_params`` / ``seq_shard_activations`` without a mesh change no
  bit.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from _torch_parity import build  # noqa: E402
from repro.configs import get_config, get_smoke_config, list_archs  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import nn as jnn  # noqa: E402

ARCHS = list_archs() + ["rhapsody-demo"]
TOL = 1e-5


def _tcfg(cfg):
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _axes(arch, full):
    """(the port's axes, the reference's) of ``arch``'s config."""
    from repro_torch.models import get_model

    cfg = get_config(arch) if full else get_smoke_config(arch)
    if full:
        _, jaxes = jspecs.abstract_params(jax_get_model(cfg), cfg)
    else:
        _, jaxes = jnn.split(jax_get_model(cfg).init(jax.random.PRNGKey(0),
                                                     cfg))
    tcfg = _tcfg(cfg)
    _, axes = get_model(tcfg).init(torch.Generator(), tcfg, device="meta",
                                   with_axes=True)
    return axes, jaxes


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_reference(arch, full):
    axes, jaxes = _axes(arch, full)
    assert axes == jaxes


class _StubMesh:
    """What both ``make_specs`` read of a mesh."""

    def __init__(self, multi_pod):
        self.axis_names = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))
        self.mesh_dim_names = self.axis_names
        sizes = (2, 16, 16) if multi_pod else (16, 16)
        self.shape = dict(zip(self.axis_names, sizes))


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _spec_leaves(tree[key], path + (key,)).items()}
    return {path: tuple(tree)}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("rules", ["TRAIN_RULES", "SERVE_RULES"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, rules, multi_pod):
    from repro_torch.launch import sharding as shd

    axes, jaxes = _axes(arch, True)
    mesh = _StubMesh(multi_pod)
    got = _spec_leaves(shd.make_specs(axes, getattr(shd, rules), mesh))
    want = _spec_leaves(jshd.make_specs(jaxes, getattr(jshd, rules), mesh))
    assert got == want


def _cache_leaves(tree, path=()):
    """{leaf path without the reference's "scan" / "pre" / "layer_i"
    levels: [(spec, number of leading layer dims)]} of a reference cache
    spec tree (a PartitionSpec per leaf)."""
    from jax.sharding import PartitionSpec

    if isinstance(tree, PartitionSpec):
        lead = 1 if "scan" in path else 0
        key = tuple(k for k in path if k not in ("scan", "pre")
                    and not k.startswith("layer_"))
        return {key: [(tuple(tree), lead)]}
    out = {}
    for k, v in tree.items():
        for key, specs in _cache_leaves(v, path + (k,)).items():
            out.setdefault(key, []).extend(specs)
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, shape, multi_pod):
    """``cache_specs`` of every arch on both production meshes equals the
    reference's, leaf by leaf: a reference leaf (scanned with a leading
    layer dim, or one of an MoE model's first dense layers without)
    against the port's stacked leaf of the same name, each spec's
    entries past their leading layer dims (None in both)."""
    from repro_torch.launch import specs

    seq, batch, _ = jspecs.SHAPES[shape]
    cfg = get_config(arch)
    mesh = _StubMesh(multi_pod)
    got = _spec_leaves(specs.cache_specs(_tcfg(cfg), mesh, batch, seq))
    want = _cache_leaves(jspecs.cache_specs(cfg, mesh, batch, seq))
    assert set(got) == set(want)
    for key, spec in got.items():
        for ref_spec, lead in want[key]:
            n = len(ref_spec) - lead
            assert spec[len(spec) - n:] == ref_spec[lead:], key
            assert all(e is None for e in spec[:len(spec) - n])


def test_cache_specs_split_what_divides():
    """The rule's outcomes on the 16 x 16 mesh at decode_32k: llama's K/V
    split their batch over "data" and their 32768 positions over "model";
    rwkv6's 32 heads and zamba2's ssm heads over "model"; a batch of 1
    (long_500k) stays whole."""
    from repro_torch.launch import specs

    mesh = _StubMesh(False)
    sp = specs.cache_specs(_tcfg(get_config("llama3.2-3b")), mesh, 128,
                           32768)
    assert sp["k"] == (None, "data", "model", None, None)
    assert sp["len"] == ("data",)
    sp = specs.cache_specs(_tcfg(get_config("rwkv6-1.6b")), mesh, 1, 524288)
    assert sp["att"]["wkv"] == (None, None, "model", None, None)
    assert sp["att"]["shift"] == (None, None, None)
    sp = specs.cache_specs(_tcfg(get_config("zamba2-2.7b")), mesh, 128,
                           32768)
    assert sp["ssm"]["ssm"] == (None, None, "data", "model", None, None)
    assert sp["ssm"]["conv"]["x"] == (None, None, "data", None, "model")


def test_rules_are_the_reference_rules():
    from repro_torch.launch import sharding as shd

    assert shd.TRAIN_RULES == jshd.TRAIN_RULES
    assert shd.SERVE_RULES == jshd.SERVE_RULES
    assert shd.opt_axes_like({"a": ("embed", "mlp")}, True) == \
        jshd.opt_axes_like({"a": ("embed", "mlp")}, True)


# ---------------------------------------------------------------------------
# Four gloo ranks: the mesh regions against their plain versions
# ---------------------------------------------------------------------------

LINEAR_CASES = [dict(mode=m, fsdp=f, seq_shard=s)
                for m, f, s in [("column", False, False),
                                ("column", True, False),
                                ("row", False, False), ("row", True, False),
                                ("row", False, True), ("row", True, True)]]


def _lid(c):
    return f"{c['mode']}-fsdp{int(c['fsdp'])}-sp{int(c['seq_shard'])}"


def _arrays():
    rng = np.random.default_rng(0)
    f = np.float32
    return {
        "x": rng.standard_normal((4, 8, 16)).astype(f),
        "w_col": rng.standard_normal((16, 32)).astype(f) * 0.2,
        "w_row": rng.standard_normal((16, 16)).astype(f) * 0.2,
        "gy_col": rng.standard_normal((4, 8, 32)).astype(f),
        "gy_row": rng.standard_normal((4, 8, 16)).astype(f),
        "table": rng.standard_normal((64, 16)).astype(f),
        "ids": rng.integers(0, 64, (4, 8)).astype(np.int32),
        "gy_emb": rng.standard_normal((4, 8, 16)).astype(f),
        "logits": rng.standard_normal((4, 8, 64)).astype(f) * 3,
        "targets": rng.integers(0, 64, (4, 8)).astype(np.int32),
        "gll": rng.standard_normal((4, 8)).astype(f),
    }


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    arrays = _arrays()
    cases = [dict(c, id=_lid(c), kind="linear") for c in LINEAR_CASES]
    cases += [dict(id="embedding", kind="embedding"),
              dict(id="loglik", kind="loglik"),
              dict(id="staged", kind="staged"),
              dict(id="shards", kind="shards",
                   cfg=dataclasses.asdict(get_smoke_config("rhapsody-demo")))]
    return arrays, ranks.spawn("mesh_ops", {"arrays": arrays, "cases": cases},
                               str(tmp_path_factory.mktemp("mesh")))


def _ok(res, key):
    r = res[key]
    assert "error" not in r, r.get("error")
    return r


def _plain_linear(arrays, case):
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    col = case["mode"] == "column"
    w = torch.from_numpy(arrays["w_col" if col else "w_row"]
                         ).requires_grad_(True)
    y = x @ w
    (y * torch.from_numpy(arrays["gy_col" if col else "gy_row"])).sum(
    ).backward()
    return y.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("case", LINEAR_CASES, ids=_lid)
def test_linear_apply_tp_equals_plain(mesh_run, case):
    arrays, res = mesh_run
    r = _ok(res, _lid(case))
    y, dx, dw = _plain_linear(arrays, case)
    np.testing.assert_allclose(r["y"], y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r["dx"], dx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r["dw"], dw, rtol=TOL, atol=TOL)
    if case["mode"] == "column":  # out features sharded on model
        assert r["placements"] == [("Shard", 0), ("Shard", 2)]
    elif case["seq_shard"]:  # Megatron-SP: reduce-scattered on the sequence
        assert r["placements"] == [("Shard", 0), ("Shard", 1)]
    else:
        assert r["placements"] == [("Shard", 0), ("Replicate",)]


def test_sharded_embedding_equals_plain(mesh_run):
    arrays, res = mesh_run
    r = _ok(res, "embedding")
    t = torch.from_numpy(arrays["table"]).requires_grad_(True)
    y = t[torch.from_numpy(arrays["ids"]).long()]
    (y * torch.from_numpy(arrays["gy_emb"])).sum().backward()
    np.testing.assert_allclose(r["y"], y.detach().numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(r["dtable"], t.grad.numpy(), rtol=TOL,
                               atol=TOL)


def test_sharded_loglik_equals_plain(mesh_run):
    arrays, res = mesh_run
    r = _ok(res, "loglik")
    lg = torch.from_numpy(arrays["logits"]).requires_grad_(True)
    ll = torch.gather(torch.log_softmax(lg, -1), -1, torch.from_numpy(
        arrays["targets"]).long()[..., None])[..., 0]
    (ll * torch.from_numpy(arrays["gll"])).sum().backward()
    np.testing.assert_allclose(r["ll"], ll.detach().numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(r["dlogits"], lg.grad.numpy(), rtol=TOL,
                               atol=TOL)


def test_local_shards_have_the_specs_shapes(mesh_run):
    _, res = mesh_run
    r = _ok(res, "shards")
    sizes = {"data": 2, "model": 2}
    for path, (shape, spec, local) in r["leaves"].items():
        want = tuple(n // (1 if e is None else sizes[e])
                     for n, e in zip(shape, spec + (None,) * len(shape)))
        assert local == want, path


def test_host_staged_all_gather_equals_gloo(mesh_run):
    _, res = mesh_run
    r = _ok(res, "staged")
    assert r["equal"]
    assert r["rows"] == [1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 4.0]


# ---------------------------------------------------------------------------
# The reference's single-device tests, ported
# ---------------------------------------------------------------------------


def test_padded_heads_exact():
    """GQA head padding (zero o-rows, per-kv-group layout) is a no-op: the
    reference's weights carried into the port, padded as the reference's
    test pads them, give the unpadded logits; the port's own init zeroes
    the pad heads' o rows."""
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy

    cfg, _, params, tcfg, tp = build(arch="llama3.2-3b")  # 6 heads, kv 2
    cfgp = cfg.scaled(pad_heads_to=8)
    tcfgp = _tcfg(cfgp)
    p = jax.tree.map(np.asarray, params)
    nkv, hd, d = cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    g_real, g_pad = cfg.n_heads // nkv, cfgp.padded_heads // nkv
    L = p["blocks"]["attn"]["q"]["w"].shape[0]
    pp = jax.tree.map(np.array, p)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((L, d, nkv, g_pad, hd)).astype(np.float32)
    q[:, :, :, :g_real] = p["blocks"]["attn"]["q"]["w"].reshape(
        L, d, nkv, g_real, hd)
    pp["blocks"]["attn"]["q"]["w"] = q.reshape(L, d, -1)
    o = np.zeros((L, nkv, g_pad, hd, d), np.float32)
    o[:, :, :g_real] = p["blocks"]["attn"]["o"]["w"].reshape(
        L, nkv, g_real, hd, d)
    pp["blocks"]["attn"]["o"]["w"] = o.reshape(L, -1, d)
    tpp = params_from_numpy(pp, tcfgp, "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32))
    batch = {"tokens": tokens}
    l0, _ = get_model(tcfg).forward(tp, batch, tcfg)
    l1, _ = get_model(tcfgp).forward(tpp, batch, tcfgp)
    np.testing.assert_allclose(l0.detach().numpy(), l1.detach().numpy(),
                               rtol=TOL, atol=TOL)
    own = get_model(tcfgp).init(torch.Generator().manual_seed(0), tcfgp,
                                device="cpu")
    ow = own["blocks"][0]["attn"]["o"]["w"].reshape(nkv, g_pad, hd, d)
    assert torch.count_nonzero(ow[:, g_real:]) == 0
    assert torch.count_nonzero(ow[:, :g_real]) == ow[:, :g_real].numel()


def test_explicit_tp_flags_are_noop_without_mesh():
    """explicit_tp / SP flags fall back exactly on a single device."""
    from repro_torch.models import get_model

    cfg, _, _, tcfg, tp = build(arch="qwen3-8b")
    tcfg2 = tcfg.scaled(explicit_tp=True, fsdp_params=True,
                        seq_shard_activations=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))}
    l0, _ = get_model(tcfg).forward(tp, batch, tcfg)
    l1, _ = get_model(tcfg2).forward(tp, batch, tcfg2)
    assert torch.equal(l0, l1)
