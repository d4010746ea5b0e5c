"""Declarative compartment-model specification.

The reference hard-codes each model as a separate Gillespie loop with
per-model propensity/stoichiometry dicts (reference gillespie_algo.py:10-233)
and branches on a ``ModelType`` enum throughout the particle filter
(reference pmcmc.py:116-175).  Here a model is *data*: a stoichiometry
matrix, a source-compartment vector, and a pure rate function — the device
simulator (epitpu.sim.tauleap), the particle filter, and PMMH are generic
over any ``CompartmentModel``.

All rate functions are written batched: ``x`` has shape ``[..., C]`` and the
result has shape ``[..., R]``, so the same code serves a single trajectory,
a particle cloud, and a (chains, particles) block without explicit vmap.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash, so a
# model instance is usable as a jit static argument despite ndarray fields.
class CompartmentModel:
    """A continuous-time Markov jump process on integer compartment counts.

    Attributes:
      name: model identifier ("sir", "seir", "sir_subgroups", ...).
      compartments: names of the C state compartments, in state-vector order.
      stoich: ``[R, C]`` int array; row r is the state change of reaction r.
      source: ``[R]`` int array; ``source[r]`` is the compartment whose count
        gates reaction r (every built-in reaction decrements exactly one
        compartment — the Euler-multinomial simulator relies on this to keep
        states non-negative without clipping).
      rate_fn: ``(x[..., C], theta[theta_dim]) -> a[..., R]`` propensities.
      theta_dim: length of the flat parameter vector (MCMC works on flat θ).
      obs_dim: number of observed columns (after ``observe_map``).
      observe_map: maps latent state ``[..., C] -> [..., obs_dim]``.  Identity
        for SIR/SEIR/per-group subgroup obs; sums over subgroups for the
        aggregated-observation variant (reference pmcmc.py:172-175, 228-231).
      terminal_compartments: indices whose total hitting zero makes the chain
        absorbing (I for SIR; E+I for SEIR).  Informational only — with zero
        rates the simulator freezes naturally, mirroring the reference's
        ``while I > 0`` loop exit (reference gillespie_algo.py:48, 119).
      theta_names: names for the flat θ entries (diagnostics / plots).
    """

    name: str
    compartments: Tuple[str, ...]
    stoich: np.ndarray
    source: np.ndarray
    rate_fn: Callable
    theta_dim: int
    obs_dim: int
    observe_map: Callable
    terminal_compartments: Tuple[int, ...]
    theta_names: Tuple[str, ...]
    init_fn: Callable = None  # (key, n, init) -> x0 [n, C]; set by factories

    @property
    def num_compartments(self) -> int:
        return len(self.compartments)

    @property
    def num_reactions(self) -> int:
        return int(self.stoich.shape[0])

    def stoich_jnp(self, dtype=jnp.float32):
        return jnp.asarray(self.stoich, dtype=dtype)

    @property
    def sources_unique(self) -> bool:
        """True when no two reactions share a source compartment — the
        simulator then needs a single batched binomial draw per substep."""
        return len(set(self.source.tolist())) == len(self.source)


def _identity_observe(x):
    return x


def make_model(
    name,
    compartments,
    stoich,
    source,
    rate_fn,
    theta_dim,
    theta_names,
    obs_dim=None,
    observe_map=_identity_observe,
    terminal_compartments=(),
    init_fn=None,
) -> CompartmentModel:
    stoich = np.asarray(stoich, dtype=np.int32)
    source = np.asarray(source, dtype=np.int32)
    if stoich.ndim != 2 or stoich.shape[1] != len(compartments):
        raise ValueError(f"stoich must be [R, {len(compartments)}], got {stoich.shape}")
    if source.shape != (stoich.shape[0],):
        raise ValueError("source must have one entry per reaction")
    # Every reaction must decrement its source by exactly 1 (Euler-multinomial
    # exit scheme); built-ins all satisfy this.
    for r in range(stoich.shape[0]):
        if stoich[r, source[r]] != -1:
            raise ValueError(
                f"reaction {r} must decrement its source compartment by 1"
            )
    if obs_dim is None:
        obs_dim = len(compartments)
    return CompartmentModel(
        name=name,
        compartments=tuple(compartments),
        stoich=stoich,
        source=source,
        rate_fn=rate_fn,
        theta_dim=theta_dim,
        obs_dim=obs_dim,
        observe_map=observe_map,
        terminal_compartments=tuple(terminal_compartments),
        theta_names=tuple(theta_names),
        init_fn=init_fn,
    )
