"""Multi-subgroup SIR with a K x K contact-rate matrix.

State is ``[s_0, i_0, r_0, s_1, i_1, r_1, ...]`` (K groups x 3 compartments).
theta is flat ``[K*K + 1]``: the beta matrix row-major, then gamma — matching
the reference's PMCMC unpacking (reference pmcmc.py:289-294).

The reference builds K^2 separate infection reactions where reaction
``(pop, pop2)`` fires at rate ``betas[pop, pop2] * s_{pop2} * i_{pop} / N_total``
and its stoichiometry moves ``s_{pop2} -> i_{pop2}``
(reference gillespie_algo.py:180-183).  Note two properties:

1. For a fixed target group g = pop2, all K reactions share the *same*
   stoichiometry (s_g - 1, i_g + 1).  Superposing Poisson processes with
   identical jumps is exact, so they merge into ONE reaction per group with
   rate ``s_g * sum_pop(beta[pop, g] * i_pop) / N_total`` — i.e. force of
   infection through the *transposed* contact matrix.  The merged model has
   2K reactions instead of K^2 + K and identical law to the reference SSA.
2. The textbook convention would use ``beta[g, j] * i_j`` (untransposed) —
   which is what the reference's *ODE generator* uses
   (reference pmcmc.py:37-51).  So the reference's SSA and ODE disagree by a
   transpose.  We default to ``reference_dynamics=True`` (transposed, matches
   the SSA used for inference) and expose the corrected variant behind the
   flag; the ODE module uses the untransposed convention like the reference.

Observation variants:
  - per-group counts (reference ModelType.SIR_SUBGROUPS): observe_map identity.
  - aggregated counts (reference ModelType.SIR_SUBGROUPS2): observation is the
    sum over groups of each compartment (reference pmcmc.py:172-175, 228-231).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from functools import lru_cache

from .base import make_model


def _unpack(theta, k):
    beta = theta[..., : k * k].reshape(theta.shape[:-1] + (k, k))
    gamma = theta[..., k * k]
    return beta, gamma


def _make_rates(k, transpose_beta):
    def _rates(x, theta):
        beta, gamma = _unpack(theta, k)
        xs = x.reshape(x.shape[:-1] + (k, 3))
        s = xs[..., 0]  # [..., K]
        i = xs[..., 1]
        n_total = jnp.sum(x, axis=-1)[..., None]
        # HIGHEST: a default-precision float32 dot may run in TF32 on a GPU
        if transpose_beta:
            # force on group g: sum_pop beta[pop, g] * i_pop  (reference SSA)
            force = jnp.einsum(
                "...p,...pg->...g", i, beta, precision=jax.lax.Precision.HIGHEST
            )
        else:
            # textbook: sum_j beta[g, j] * i_j
            force = jnp.einsum(
                "...gj,...j->...g", beta, i, precision=jax.lax.Precision.HIGHEST
            )
        a_infect = s * force / n_total  # [..., K]
        a_recover = gamma[..., None] * i  # [..., K]
        return jnp.concatenate([a_infect, a_recover], axis=-1)

    return _rates


def _make_init(k):
    def _init(key, n_particles, n_population=None, mu=None):
        """Per group g: I ~ Poisson(mu[g]), S = n_population[g] - I, R = 0
        (reference pmcmc.py:165-169)."""
        mu = jnp.asarray(mu, jnp.float32)
        pops = jnp.asarray(n_population, jnp.float32)
        i0 = jax.random.poisson(key, mu, shape=(n_particles, k)).astype(jnp.float32)
        s0 = pops[None, :] - i0
        r0 = jnp.zeros_like(i0)
        x = jnp.stack([s0, i0, r0], axis=-1)  # [n, K, 3]
        return x.reshape(n_particles, 3 * k)

    return _init


def _aggregate_groups(k):
    def observe(x):
        xs = x.reshape(x.shape[:-1] + (k, 3))
        return jnp.sum(xs, axis=-2)

    return observe


@lru_cache(maxsize=None)  # identity-stable: repeated calls hit the jit cache
def sir_subgroups_model(k=2, aggregated_obs=False, reference_dynamics=True):
    """K-group SIR.  ``aggregated_obs=True`` gives the reference's
    SIR_SUBGROUPS2 (observations summed over groups)."""
    comps = tuple(f"{c}_{g}" for g in range(k) for c in ("s", "i", "r"))
    stoich = np.zeros((2 * k, 3 * k), dtype=np.int32)
    source = np.zeros(2 * k, dtype=np.int32)
    for g in range(k):
        # infection into group g: s_g -> i_g
        stoich[g, 3 * g + 0] = -1
        stoich[g, 3 * g + 1] = 1
        source[g] = 3 * g + 0
        # recovery in group g: i_g -> r_g
        stoich[k + g, 3 * g + 1] = -1
        stoich[k + g, 3 * g + 2] = 1
        source[k + g] = 3 * g + 1
    theta_names = tuple(
        f"beta_{a}{b}" for a in range(k) for b in range(k)
    ) + ("gamma",)
    return make_model(
        name="sir_subgroups2" if aggregated_obs else "sir_subgroups",
        compartments=comps,
        stoich=stoich,
        source=source,
        rate_fn=_make_rates(k, transpose_beta=reference_dynamics),
        theta_dim=k * k + 1,
        theta_names=theta_names,
        obs_dim=3 if aggregated_obs else 3 * k,
        observe_map=_aggregate_groups(k) if aggregated_obs else (lambda x: x),
        terminal_compartments=tuple(3 * g + 1 for g in range(k)),
        init_fn=_make_init(k),
    )
