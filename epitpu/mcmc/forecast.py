"""Posterior-predictive forecasting.

Reference: tests/pred_tmps.py:55-73 — for each posterior draw j, continue a
Gillespie run from the last filtered state with theta_j up to the horizon
(joblib process fan-out, one task per draw).  Here the whole posterior batch
is one vmapped tau-leap simulation.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.base import CompartmentModel
from ..sim.tauleap import simulate


@partial(jax.jit, static_argnums=(0, 4, 5))
def posterior_forecast(
    model: CompartmentModel,
    key,
    thetas,
    last_states,
    horizon: int,
    steps_per_unit: int = 20,
):
    """thetas: [n, d_model] posterior draws (model parameters only);
    last_states: [n, C] matching filtered states; returns [n, horizon+1, C]
    including the starting state (the reference concatenates filtered past +
    forecast, pred_tmps.py:75-78).  One vmapped substep-scan simulation."""
    keys = jax.random.split(key, thetas.shape[0])

    def one(k, th, x0):
        return simulate(model, k, x0[None, :], th, horizon, steps_per_unit)[:, 0, :]

    return jax.vmap(one)(keys, thetas, last_states)


def forecast_from_result(
    model,
    key,
    result,
    horizon,
    infer_obs_param=False,
    thin=1,
    steps_per_unit=20,
):
    """Forecast from a PMMHResult: uses each (thinned) iteration's stored
    trajectory end-state and theta.  Returns [n_draws, horizon+1, C]."""
    thetas = jnp.asarray(result.thetas)[::thin]
    if infer_obs_param:
        thetas = thetas[:, :-1]
    last_states = jnp.asarray(result.sampled_trajs)[::thin, -1, :]
    return posterior_forecast(
        model, key, thetas, last_states, horizon, steps_per_unit
    )
