"""ABC rejection sampling (reference abc_algo.py / tests/test_abc_sir.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epitpu.abc import abc_rejection, reference_sir_distance
from epitpu.models import sir_model
from epitpu.ode import sir_simulate_discrete


@pytest.fixture(scope="module")
def observed_sir():
    """Reference tests/simulated_data.py workload: ODE data, y0=(480, 20, 0),
    beta=2, gamma=1 (simulated_data.py:14-16)."""
    t = np.linspace(0, 10, 100)
    df = sir_simulate_discrete((480.0, 20.0, 0.0), t, 2.0, 1.0)
    return df[["susceptible", "infected", "removed"]].to_numpy()


def test_distance_function_matches_reference():
    """reference abc_algo.py:10-13."""
    sim = jnp.asarray(np.arange(24, dtype=np.float32).reshape(4, 2, 3))
    obs = jnp.asarray(np.ones((4, 3), np.float32))
    d = np.asarray(reference_sir_distance(sim, obs))
    for k in range(2):
        expect = 0.5 * (
            np.abs(np.asarray(sim)[:, k, 1] - 1).mean()
            + np.abs(np.asarray(sim)[:, k, 2] - 1).mean()
        )
        np.testing.assert_allclose(d[k], expect, rtol=1e-6)


def test_abc_recovers_parameters(observed_sir):
    m = sir_model()
    res = abc_rejection(
        m,
        jax.random.PRNGKey(0),
        observed_sir,
        n_samples=50,
        threshold=12.0,
        priors={"beta": (0.0, 4.0), "gamma": (0.0, 4.0)},
        batch_size=256,
    )
    beta = res.posterior["beta"]
    gamma = res.posterior["gamma"]
    assert len(beta) == 50
    assert res.trajectories.shape[0] == 50
    assert res.trajectories.shape[1] == observed_sir.shape[0]
    assert 0 < res.acceptance_rate <= 1
    # accepted betas/gammas concentrate around the truth relative to U(0,4)
    assert abs(np.median(beta) - 2.0) < 0.8
    assert abs(np.median(gamma) - 1.0) < 0.6


def test_abc_accepted_trajectories_fit(observed_sir):
    m = sir_model()
    res = abc_rejection(
        m,
        jax.random.PRNGKey(1),
        observed_sir,
        n_samples=10,
        threshold=12.0,
        priors={"beta": (0.0, 4.0), "gamma": (0.0, 4.0)},
        batch_size=256,
    )
    sim = jnp.swapaxes(jnp.asarray(res.trajectories), 0, 1)  # [T, n, C]
    d = np.asarray(reference_sir_distance(sim, jnp.asarray(observed_sir, jnp.float32)))
    assert (d <= 12.0 + 1e-3).all()


def test_abc_impossible_threshold_raises(observed_sir):
    m = sir_model()
    with pytest.raises(RuntimeError):
        abc_rejection(
            m,
            jax.random.PRNGKey(2),
            observed_sir,
            n_samples=5,
            threshold=1e-6,
            priors={"beta": (0.0, 4.0), "gamma": (0.0, 4.0)},
            batch_size=64,
            max_trials=256,
        )


def test_backend_dispatch_cpu_falls_back_to_xla(sir_dataset):
    """ABC runs as one XLA program on every backend: the accepted draws
    and their trajectories come back finite and correctly shaped."""
    import jax

    from epitpu.abc import abc_rejection
    from epitpu.models import sir_model

    y, _ = sir_dataset
    res = abc_rejection(
        sir_model(), jax.random.PRNGKey(0), y[:5], n_samples=4,
        threshold=500.0, priors={"beta": (0, 5), "gamma": (0, 5)},
        batch_size=128, steps_per_unit=5,
    )
    assert res.trajectories.shape == (4, 5, 3)
    assert np.isfinite(res.trajectories).all()
    for name in ("beta", "gamma"):
        assert res.posterior[name].shape == (4,)
        assert np.isfinite(res.posterior[name]).all()
    assert res.trials % 128 == 0 and 0 < res.acceptance_rate <= 1
