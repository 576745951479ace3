"""The port's simulation payloads (``substrate/simulation.py``) against the
JAX package's: each step function on the same numpy arrays (heat within
1e-6, LJ and the surrogate within 1e-5 relative); each payload end to end
with its draw replaced by the reference's ``jax.random`` draw (the two
packages draw from different generators, so only the inputs can be made
equal), over the row split across ranks; ``noop``; the CPU generator's
draws; and the card as the default device."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.substrate import simulation as jsim  # noqa: E402
from repro_torch.substrate import simulation as sim  # noqa: E402


@pytest.fixture
def reference_draws(monkeypatch):
    """Replace each payload's draw with the reference's."""
    def heat(n, seed):
        return torch.from_numpy(np.array(
            jax.random.uniform(jax.random.PRNGKey(seed), (n, n))))

    def lj(n_particles, seed):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), (n_particles, 3)) * 4.0))

    def surrogate(dim, d_in, hidden, seed):
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
        return tuple(torch.from_numpy(np.array(a)) for a in (
            jax.random.normal(k1, (32, dim)),
            jax.random.normal(k2, (d_in, hidden)) * 0.1,
            jax.random.normal(k3, (hidden, 1)) * 0.1))

    monkeypatch.setattr(sim, "_heat_draw", heat)
    monkeypatch.setattr(sim, "_lj_draw", lj)
    monkeypatch.setattr(sim, "_surrogate_draw", surrogate)


def test_heat_steps_match_reference():
    grid = np.random.RandomState(0).rand(40, 33).astype(np.float32)
    want = np.asarray(jsim._heat_steps(jnp.asarray(grid), 12))
    got = sim._heat_steps(torch.from_numpy(grid), 12).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not np.array_equal(got, grid)


def test_lj_steps_match_reference():
    rng = np.random.RandomState(1)
    pos = (rng.rand(48, 3) * 4.0).astype(np.float32)
    vel = (rng.randn(48, 3) * 0.1).astype(np.float32)
    wp, wv = jsim._lj_steps(jnp.asarray(pos), jnp.asarray(vel), 4)
    gp, gv = sim._lj_steps(torch.from_numpy(pos), torch.from_numpy(vel), 4)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-3)


def test_mlp_forward_matches_reference():
    rng = np.random.RandomState(2)
    x, w1, w2 = (rng.randn(*s).astype(np.float32)
                 for s in ((8, 16), (16, 32), (32, 1)))
    want = np.asarray(jsim._mlp_forward(*map(jnp.asarray, (x, w1, w2)), 32))
    got = sim._mlp_forward(*map(torch.from_numpy, (x, w1, w2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ranks", [1, 3, 4, 64])
def test_heat_stencil_matches_reference_over_the_rank_split(reference_draws,
                                                            ranks):
    """Rows split across ranks, each block with its two halo rows, the
    blocks concatenated (so more rows than the grid), as the reference."""
    want = jsim.heat_stencil(n=32, steps=6, seed=3, _ranks=ranks)
    got = sim.heat_stencil(n=32, steps=6, seed=3, _ranks=ranks,
                           device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_lj_step_matches_reference(reference_draws):
    want = jsim.lj_step(n_particles=64, steps=5, seed=4)
    got = sim.lj_step(n_particles=64, steps=5, seed=4, device="cpu")
    assert got.shape == (64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("x_rank", [None, 1, 2])
def test_surrogate_eval_matches_reference(reference_draws, x_rank):
    x = {None: None, 1: np.linspace(-1, 1, 24, dtype=np.float32),
         2: np.random.RandomState(5).randn(4, 24)}[x_rank]
    want = jsim.surrogate_eval(x, dim=16, hidden=32, seed=6)
    got = sim.surrogate_eval(x, dim=16, hidden=32, seed=6, device="cpu")
    assert got.shape == want.shape == ({None: (32, 1), 1: (1, 1),
                                        2: (4, 1)}[x_rank])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_draws_come_from_a_seeded_cpu_generator():
    """The same seed gives the same numbers, whatever the device computes
    them; each payload's result depends on its seed."""
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(sim._heat_draw(8, 7), torch.rand((8, 8),
                                                        generator=gen))
    assert sim._lj_draw(5, 0).device.type == "cpu"
    a = sim.heat_stencil(n=16, steps=2, seed=1, device="cpu")
    assert np.array_equal(a, sim.heat_stencil(n=16, steps=2, seed=1,
                                              device="cpu"))
    assert not np.array_equal(a, sim.heat_stencil(n=16, steps=2, seed=2,
                                                  device="cpu"))
    s = sim.surrogate_eval(dim=8, hidden=16, seed=0, device="cpu")
    assert not np.array_equal(s, sim.surrogate_eval(dim=8, hidden=16,
                                                    seed=1, device="cpu"))


def test_noop_takes_anything_and_returns_none():
    assert sim.noop() is None
    assert sim.noop(1, 2, _ranks=4, _placement=object()) is None


@pytest.mark.parametrize("call", [
    lambda: sim.heat_stencil(n=8, steps=1),
    lambda: sim.lj_step(n_particles=4, steps=1),
    lambda: sim.surrogate_eval(dim=4, hidden=4)], ids=["heat", "lj",
                                                       "surrogate"])
def test_the_card_is_the_default_device(monkeypatch, call):
    """With no ``device``, a payload asks for the CUDA card, and with no
    card it raises rather than computing on the CPU."""
    asked = []
    real = sim.resolve_device
    monkeypatch.setattr(sim, "resolve_device",
                        lambda d=None: asked.append(d) or real(d))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert asked == [None]
