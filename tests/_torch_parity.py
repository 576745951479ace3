"""Shared set-up for the PyTorch port's parity tests: one reference config,
its JAX weights, and the same weights carried into the port through numpy;
batches in both packages' tensors; reference trees compared with the
port's per-layer ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config, get_smoke_config
from repro.models import get_model, nn


def dense_cfg():
    """The dense config of ``tests/test_paged_serving.py``."""
    return get_config("rhapsody-demo").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512)


def build(cfg=None, arch=None, seed=0):
    """-> (cfg, api, params) for the JAX package and (tcfg, tparams) for
    the port, on the CPU, from the same weights."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import params_from_numpy

    if cfg is None:
        cfg = get_smoke_config(arch) if arch else dense_cfg()
    api = get_model(cfg)
    params, _ = nn.split(api.init(jax.random.PRNGKey(seed), cfg))
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return cfg, api, params, tcfg, tparams


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def fresh(tparams):
    """A copy of the port's parameters that takes gradients."""
    from repro_torch.training import optim

    return optim.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          tparams)


def per_layer(tree, dtype=np.float32):
    """Reference tree -> {port path: ndarray}: a ``blocks`` or
    ``enc_blocks`` leaf [L, ...] split into L per-layer leaves, a ``groups``
    leaf [G, K, ...] into G x K (``dtype=None`` keeps each leaf's dtype)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
            return
        a = np.asarray(t) if dtype is None else np.asarray(t, dtype)
        if path[0] in ("blocks", "enc_blocks"):
            for i in range(a.shape[0]):
                out[(path[0], i) + path[1:]] = a[i]
        elif path[0] == "groups":
            for g in range(a.shape[0]):
                for k in range(a.shape[1]):
                    out[("groups", g, k) + path[1:]] = a[g, k]
        else:
            out[path] = a

    walk(tree, ())
    return out


def assert_tree_close(ref_tree, tparams, rtol, atol):
    """Every leaf of the port's tree against the reference's, per layer."""
    from repro_torch.training import optim

    want = per_layer(ref_tree)
    got = dict(optim.named_leaves(tparams))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(), want[path],
                                   rtol=rtol, atol=atol, err_msg=str(path))
