"""Likelihood-surface exploration and offline MH re-screening.

Counterpart of the reference's likelihood-map workflow
(reference tests/testing_sbgrps.py:35-91): (a) evaluate the particle-filter
marginal likelihood over a grid of theta candidates and threshold it into a
boolean "high-likelihood" map; (b) re-screen a RECORDED chain offline by
re-running the Metropolis accept/reject against the stored likelihoods
without re-running any filters.

Device-native redesign: the grid is evaluated as ONE vmapped batch of filters
in a single compiled program (the reference loops a Python PF per grid
point), and the re-screen runs in log space as a ``lax.scan`` — replacing
the reference's ``10**constant`` string-parsed underflow rescale
(testing_sbgrps.py:68-71) and its use of ``multivariate_normal.cdf`` where
a density belongs (testing_sbgrps.py:74-83; for a symmetric random walk the
proposal terms cancel exactly, see epitpu.mcmc.pmmh module doc).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..smc.filter import particle_filter


@partial(jax.jit, static_argnums=(0, 1, 5, 8))
def _surface_jit(model, obs_loglik, keys, y, thetas, n_particles,
                 n_population, mu, steps_per_unit, obs_param):
    def one(key, theta):
        return particle_filter(
            model, obs_loglik, key, y, theta, obs_param,
            n_particles=n_particles, n_population=n_population, mu=mu,
            steps_per_unit=steps_per_unit,
        ).log_likelihood

    return jax.vmap(one)(keys, thetas)


def likelihood_surface(
    model,
    obs_loglik,
    key,
    y,
    thetas,
    obs_param=0.1,
    n_particles: int = 256,
    n_population=4820,
    mu=20.0,
    steps_per_unit: int = 20,
    batch_size: int = 256,
):
    """PF log-likelihood at every row of ``thetas [G, d]`` -> [G].

    One vmapped filter batch per ``batch_size`` grid points, all on device.
    Use ``theta_grid`` to build a mesh over parameter ranges.  The
    reference's equivalent is a hand-rolled loop of Python particle filters
    feeding a thresholded boolean map (testing_sbgrps.py:46-49).
    """
    thetas = jnp.asarray(thetas, jnp.float32)
    g = thetas.shape[0]
    out = []
    for start in range(0, g, batch_size):
        chunk = thetas[start : start + batch_size]
        keys = jax.random.split(
            jax.random.fold_in(key, start), chunk.shape[0]
        )
        out.append(
            _surface_jit(
                model, obs_loglik, keys, y, chunk, n_particles,
                jnp.asarray(n_population, jnp.float32),
                jnp.asarray(mu, jnp.float32), steps_per_unit,
                jnp.asarray(obs_param, jnp.float32),
            )
        )
    return np.concatenate([np.asarray(o) for o in out])


def theta_grid(ranges, points_per_dim: int):
    """Cartesian grid over ``ranges = [(lo, hi), ...]`` -> [P^d, d]."""
    axes = [np.linspace(lo, hi, points_per_dim) for lo, hi in ranges]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=1).astype(np.float32)


def high_likelihood_map(thetas, log_likelihoods, quantile: float = 0.5):
    """Boolean map of grid points above the given log-likelihood quantile —
    the reference's ``likelihoods > np.mean(likelihoods)`` subset
    (testing_sbgrps.py:46-49), quantile-based and in log space."""
    log_likelihoods = np.asarray(log_likelihoods)
    finite = np.isfinite(log_likelihoods)
    thresh = np.quantile(log_likelihoods[finite], quantile) if finite.any() \
        else np.inf
    mask = finite & (log_likelihoods >= thresh)
    return mask, np.asarray(thetas)[mask]


def offline_rescreen(key, thetas, log_likelihoods):
    """Re-run the MH accept/reject over a recorded chain's (theta, log Z)
    pairs without re-running any particle filters.

    The reference re-screens a saved chain with fresh uniforms against the
    stored likelihoods (testing_sbgrps.py:67-91).  For the symmetric MVN
    random walk every proposal-density factor cancels, so the log ratio is
    simply ``logZ[i] - logZ_current`` (the reference multiplies in
    ``multivariate_normal.cdf`` factors — a quirk of that script — and
    rescales by a string-parsed ``10**constant``; both disappear in log
    space).  Returns (rescreened thetas [M, d], acceptances).
    """
    thetas = jnp.asarray(thetas, jnp.float32)
    lls = jnp.asarray(log_likelihoods, jnp.float32)
    m = thetas.shape[0]
    log_us = jnp.log(jax.random.uniform(key, (m - 1,)))

    def step(carry, inp):
        theta_cur, ll_cur, acc = carry
        theta_i, ll_i, log_u = inp
        accept = jnp.isfinite(ll_i) & (log_u < (ll_i - ll_cur))
        theta_cur = jnp.where(accept, theta_i, theta_cur)
        ll_cur = jnp.where(accept, ll_i, ll_cur)
        return (theta_cur, ll_cur, acc + accept.astype(jnp.int32)), theta_cur

    (theta_f, ll_f, acc), out = jax.lax.scan(
        step,
        (thetas[0], lls[0], jnp.asarray(1, jnp.int32)),
        (thetas[1:], lls[1:], log_us),
    )
    chain = jnp.concatenate([thetas[:1], out], axis=0)
    return np.asarray(chain), int(acc)
