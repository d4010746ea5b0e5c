"""Simulator validation: tau-leap vs exact SSA vs ODE mean field
(the reference's de facto SSA-vs-ODE overlay check, SURVEY.md section 4.2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epitpu.models import sir_model, seir_model, sir_subgroups_model
from epitpu.ode import integrate, sir_rhs
from epitpu.sim import (
    advance,
    default_max_events,
    exact_advance,
    exact_simulate_grid,
    simulate,
)

THETA = jnp.array([2.0, 1.0])
X0 = [4800.0, 20.0, 0.0]


def _cloud(b):
    return jnp.tile(jnp.asarray(X0), (b, 1))


def test_tauleap_conserves_population_and_nonneg():
    m = sir_model()
    traj = simulate(m, jax.random.PRNGKey(0), _cloud(128), THETA, 15, 20)
    tot = np.asarray(traj).sum(axis=-1)
    np.testing.assert_allclose(tot, 4820.0, rtol=0, atol=1e-3)
    assert (np.asarray(traj) >= 0).all()
    # states are integer-valued
    assert np.allclose(np.asarray(traj), np.round(np.asarray(traj)))


def test_tauleap_matches_exact_ssa_moments():
    """Mean/std of I(t) from the tau-leap kernel must agree with the exact
    SSA within a few percent at the default resolution."""
    m = sir_model()
    b = 2048
    cap = default_max_events(m, X0)
    ex = exact_simulate_grid(m, jax.random.PRNGKey(1), _cloud(b), THETA, 12, cap)
    tl = simulate(m, jax.random.PRNGKey(2), _cloud(b), THETA, 12, 40)
    for t in (3, 5, 8):
        me, se = float(jnp.mean(ex[t, :, 1])), float(jnp.std(ex[t, :, 1]))
        mt, st = float(jnp.mean(tl[t, :, 1])), float(jnp.std(tl[t, :, 1]))
        assert abs(mt - me) < 0.05 * max(me, 50.0), (t, me, mt)
        assert abs(st - se) < 0.15 * max(se, 10.0), (t, se, st)


def test_fast_rbg_sampler_matches_exact_moments():
    """The rbg-key variant (sampler="fast_rbg", the production preset's
    sampler) must produce the same trajectory law as the threefry "fast"
    sampler — compare both against the exact SSA."""
    m = sir_model()
    b = 2048
    cap = default_max_events(m, X0)
    ex = exact_simulate_grid(m, jax.random.PRNGKey(1), _cloud(b), THETA, 8, cap)
    rb = simulate(m, jax.random.PRNGKey(4), _cloud(b), THETA, 8, 40,
                  sampler="fast_rbg")
    tot = np.asarray(rb).sum(axis=-1)
    np.testing.assert_allclose(tot, 4820.0, rtol=0, atol=1e-3)
    for t in (3, 5, 8):
        me, se = float(jnp.mean(ex[t, :, 1])), float(jnp.std(ex[t, :, 1]))
        mt, st = float(jnp.mean(rb[t, :, 1])), float(jnp.std(rb[t, :, 1]))
        assert abs(mt - me) < 0.05 * max(me, 50.0), (t, me, mt)
        assert abs(st - se) < 0.15 * max(se, 10.0), (t, se, st)


def test_exact_ssa_matches_ode_mean_field():
    """Exact SSA ensemble mean should track the deterministic ODE early on
    (before stochastic timing spread flattens the mean)."""
    m = sir_model()
    cap = default_max_events(m, X0)
    ex = exact_simulate_grid(m, jax.random.PRNGKey(3), _cloud(2048), THETA, 4, cap)
    t_grid = jnp.linspace(0.0, 4.0, 41)
    sol = integrate(sir_rhs, jnp.asarray(X0), THETA, t_grid, 10)
    for t in (1, 2, 3):
        ode_i = float(sol[t * 10, 1])
        ssa_i = float(jnp.mean(ex[t, :, 1]))
        assert abs(ssa_i - ode_i) < 0.12 * ode_i, (t, ode_i, ssa_i)


def test_absorbing_state_freezes():
    m = sir_model()
    x = jnp.array([[100.0, 0.0, 20.0]])  # I = 0: no reactions possible
    out = advance(m, jax.random.PRNGKey(0), x, THETA, 5.0, 20)
    np.testing.assert_allclose(out, x)
    out_e = exact_advance(m, jax.random.PRNGKey(0), x, THETA, 5.0, 64)
    np.testing.assert_allclose(out_e, x)


def test_negative_theta_is_nan_safe():
    """PMMH evaluates negative proposals under vmap and discards them — the
    simulator must return finite states, not NaNs."""
    m = sir_model()
    out = advance(m, jax.random.PRNGKey(0), _cloud(8), jnp.array([-1.0, -2.0]), 1.0, 20)
    assert np.isfinite(np.asarray(out)).all()


def test_seir_tauleap_runs():
    m = seir_model()
    x0 = jnp.tile(jnp.array([4800.0, 0.0, 20.0, 0.0]), (64, 1))
    traj = simulate(m, jax.random.PRNGKey(0), x0, jnp.array([4.0, 1.0, 1.0]), 10, 20)
    assert traj.shape == (11, 64, 4)
    np.testing.assert_allclose(np.asarray(traj).sum(-1), 4820.0, atol=1e-3)
    # epidemic should actually progress: R grows
    assert float(traj[-1, :, 3].mean()) > 500


def test_subgroups_tauleap_vs_exact():
    m = sir_subgroups_model(k=2)
    beta = np.array([[5.0, 2.0], [1.0, 3.0]])
    theta = jnp.asarray(np.concatenate([beta.reshape(-1), [0.5]]), jnp.float32)
    x0 = jnp.tile(jnp.array([2000.0, 30.0, 0.0, 3000.0, 40.0, 0.0]), (512, 1))
    cap = default_max_events(m, [2030, 3040])
    ex = exact_simulate_grid(m, jax.random.PRNGKey(1), x0, theta, 6, cap)
    tl = simulate(m, jax.random.PRNGKey(2), x0, theta, 6, 40)
    for t in (2, 4):
        for c in (1, 4):  # infected of each group
            me = float(jnp.mean(ex[t, :, c]))
            mt = float(jnp.mean(tl[t, :, c]))
            assert abs(mt - me) < 0.08 * max(me, 30.0), (t, c, me, mt)


def test_exact_np_oracle_agrees_with_device_exact():
    """Tiny-population check that the numpy SSA and device SSA share a law."""
    from epitpu.sim import grid_from_events, simulate_exact_np

    m = sir_model()
    theta = np.array([2.0, 1.0])
    x0 = np.array([95.0, 5.0, 0.0])
    rng = np.random.default_rng(0)
    host = np.stack(
        [
            grid_from_events(*simulate_exact_np(m, rng, x0, theta, 5.0), 5)
            for _ in range(200)
        ]
    )
    dev = exact_simulate_grid(
        m,
        jax.random.PRNGKey(0),
        jnp.tile(jnp.asarray(x0, jnp.float32), (512, 1)),
        jnp.asarray(theta, jnp.float32),
        5,
        default_max_events(m, x0),
    )
    for t in (2, 4):
        h = host[:, t, 1].mean()
        d = float(jnp.mean(dev[t, :, 1]))
        # loose: both are MC estimates on 200/512 draws of a small population
        assert abs(h - d) < 6.0, (t, h, d)
