"""Shared set-up for the PyTorch port's parity tests: one reference config,
its JAX weights, and the same weights carried into the port through numpy."""
import dataclasses

import jax
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
