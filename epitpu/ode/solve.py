"""Deterministic mean-field ODE solvers for synthetic data generation.

Device-native replacement for the reference's scipy ``odeint`` pipeline
(reference pmcmc.py:16-113): classic RK4 under ``lax.scan`` on a dense grid,
then the reference's integer-grid resampling idiom (ceil the times, keep the
last dense row at each integer day — reference pmcmc.py:66-73).

The subgroup RHS uses the *untransposed* contact matrix, exactly like the
reference's ODE generator (reference pmcmc.py:37-51) — note this differs by a
transpose from the reference's subgroup SSA (see epitpu.models.subgroups).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def sir_rhs(y, theta):
    beta, gamma = theta[0], theta[1]
    n = jnp.sum(y)
    s, i, _ = y[0], y[1], y[2]
    ds = -beta * s * i / n
    di = (beta * s / n - gamma) * i
    dr = gamma * i
    return jnp.stack([ds, di, dr])


def seir_rhs(y, theta):
    beta, alpha, gamma = theta[0], theta[1], theta[2]
    n = jnp.sum(y)
    s, e, i, _ = y[0], y[1], y[2], y[3]
    ds = -beta * s * i / n
    de = beta * s * i / n - alpha * e
    di = alpha * e - gamma * i
    dr = gamma * i
    return jnp.stack([ds, de, di, dr])


def make_sir_subgroups_rhs(k):
    """y = [s_0, i_0, r_0, ...]; theta = beta(KxK row-major) ++ [gamma]."""

    def rhs(y, theta):
        beta = theta[: k * k].reshape(k, k)
        gamma = theta[k * k]
        ys = y.reshape(k, 3)
        s, i = ys[:, 0], ys[:, 1]
        n = jnp.sum(y)
        # untransposed, as reference pmcmc.py:46-47; HIGHEST keeps the dot
        # out of TF32 on a GPU
        force = jnp.matmul(beta, i, precision=jax.lax.Precision.HIGHEST)
        ds = -s * force / n
        di = s * force / n - gamma * i
        dr = gamma * i
        return jnp.stack([ds, di, dr], axis=-1).reshape(3 * k)

    return rhs


@partial(jax.jit, static_argnums=(0, 4))
def integrate(rhs, y0, theta, t_grid, substeps=10):
    """RK4 integration returning the solution at every point of ``t_grid``
    (monotone, not necessarily uniform), with ``substeps`` RK4 steps between
    consecutive grid points."""
    y0 = jnp.asarray(y0, jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    t_grid = jnp.asarray(t_grid, y0.dtype)

    def rk4(y, h):
        k1 = rhs(y, theta)
        k2 = rhs(y + 0.5 * h * k1, theta)
        k3 = rhs(y + 0.5 * h * k2, theta)
        k4 = rhs(y + h * k3, theta)
        return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def step(y, dt):
        h = dt / substeps

        def sub(y, _):
            return rk4(y, h), None

        y_next, _ = jax.lax.scan(sub, y, None, length=substeps)
        return y_next, y_next

    dts = jnp.diff(t_grid)
    _, traj = jax.lax.scan(step, y0, dts)
    return jnp.concatenate([y0[None], traj], axis=0)


def discretize_to_integer_grid(t_grid, solution):
    """Reference idiom: ceil the times and keep the LAST dense row at each
    integer time 0..ceil(t_max) (reference pmcmc.py:66-73).  Host-side."""
    t = np.ceil(np.asarray(t_grid)).astype(int)
    sol = np.asarray(solution)
    t_max = int(t[-1])
    rows = []
    for day in range(t_max + 1):
        idx = np.nonzero(t == day)[0]
        rows.append(sol[idx[-1]])
    return np.arange(t_max + 1), np.stack(rows)


def solve_on_integer_grid(rhs, y0, theta, t, substeps=10):
    """``integrate`` then ``discretize_to_integer_grid``: numpy
    ``(days [T], states [T, C])``, the arrays behind the DataFrame
    wrappers below, with no pandas import."""
    sol = integrate(rhs, y0, jnp.asarray(theta), t, substeps)
    return discretize_to_integer_grid(t, sol)


def _as_frame(days, states, columns):
    import pandas as pd

    data = {"time": days}
    for j, c in enumerate(columns):
        data[c] = states[:, j]
    return pd.DataFrame(data)


def sir_simulate_discrete(y0, t, beta, gamma, substeps=10):
    """Drop-in equivalent of reference pmcmc.py:54-73 (daily SIR DataFrame)."""
    days, states = solve_on_integer_grid(sir_rhs, y0, [beta, gamma], t, substeps)
    return _as_frame(days, states, ["susceptible", "infected", "removed"])


def seir_simulate_discrete(y0, t, beta, alpha, gamma, substeps=10):
    """Drop-in equivalent of reference pmcmc.py:76-96."""
    days, states = solve_on_integer_grid(
        seir_rhs, y0, [beta, alpha, gamma], t, substeps
    )
    return _as_frame(days, states, ["susceptible", "exposed", "infected", "removed"])


def sir_subgroups_simulate_discrete(y0, t, beta, gamma, substeps=10):
    """Drop-in equivalent of reference pmcmc.py:99-113.  ``y0``: [K, 3] array;
    ``beta``: [K, K]."""
    y0 = np.asarray(y0, dtype=float)
    k = y0.shape[0]
    theta = jnp.concatenate(
        [jnp.asarray(beta, jnp.float32).reshape(-1), jnp.asarray([gamma], jnp.float32)]
    )
    days, states = solve_on_integer_grid(
        make_sir_subgroups_rhs(k), y0.reshape(-1), theta, t, substeps
    )
    cols = [
        f"{name}{g}" for g in range(k) for name in ("susceptible", "infected", "removed")
    ]
    return _as_frame(days, states, cols)
