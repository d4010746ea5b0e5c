"""Device forward simulator: vectorized Euler-multinomial tau-leaping.

This replaces the reference's per-particle Python Gillespie event loop
(reference gillespie_algo.py:48-73: draw tau ~ Exp, draw reaction, update,
repeat) with a fixed-step scheme that suits an accelerator: static shapes,
substeps scanned inside one XLA computation, and ONE batched binomial draw
per substep for the whole particle cloud.

Scheme (chain-binomial / Euler-multinomial, the standard discretization used
by pomp's ``reulermultinom``): over a substep of length dt, reaction r with
per-capita hazard mu_r fires

    n_r ~ Binomial(x[source_r], 1 - exp(-mu_r * dt))

(competing hazards per source compartment when several reactions share one —
the built-in models don't, so each substep is a single [..., R] binomial).
This keeps counts non-negative *exactly* (no clipping bias) and converges to
the exact SSA law as dt -> 0; ``steps_per_unit`` is the accuracy knob.
(A midpoint predictor variant was tried and *increased* bias for these
convex-growth epidemics, so it was removed.)

Absorbing states need no special handling: when the infectious compartments
hit zero all rates vanish and the binomials draw zeros, freezing the state —
the same effect as the reference's ``while I > 0`` loop exit
(reference gillespie_algo.py:48, 119, 193).

States are float32 holding integer values (exact below 2^24), so no casts
are needed between the samplers and the state update.  The two small
matrix products of a substep (the competing-hazard sum and the
``n_events @ stoich`` state update) are written as unrolled sums over the
model's static nonzero entries rather than as ``dot_general``: a backend
may run a float32 dot in TF32, which keeps integers exact only below 2^11,
and the unrolled form is exact on every backend; with R, C <= 6 it is a
handful of elementwise ops.
Binomial draws use the fast hybrid sampler (epitpu.sim.samplers) by
default; pass ``sampler="exact"`` for gold-standard validation runs.

The substep loop is a ``lax.scan`` with ``unroll=10`` by default.  That
value was chosen by an A/B on an earlier accelerator and has not been
measured on the GPU; full unrolling at large configs made XLA compile
times grow past ten minutes there.  Call ``advance`` inside an enclosing
``jax.jit`` (the filter and PMMH entry points are jitted) so the substeps
compile into one program.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CompartmentModel
from .samplers import get_binomial_sampler


def _to_rbg(key):
    """Re-wrap a (threefry) PRNG key as an ``rbg`` key, whose bits come from
    XLA's ``RngBitGenerator`` instead of the threefry hash.  Still fully
    deterministic given the key; the stream just differs from threefry's
    (and may differ across backends), which is why it is opt-in via
    ``sampler="fast_rbg"``.  The binomial law is the same
    (tests/test_sim.py::test_fast_rbg_sampler_matches_exact_moments); its
    speed against threefry has not been measured on the GPU."""
    if jnp.issubdtype(jnp.asarray(key).dtype, jax.dtypes.prng_key):
        data = jax.random.key_data(key)
    else:
        data = jnp.asarray(key)
    # concatenate along the last axis (batch-safe: (B, 2) -> (B, 4); a
    # plain tile+slice would corrupt batched key shapes) and idempotent for
    # keys that are already 4-word rbg data
    return jax.random.wrap_key_data(
        jnp.concatenate([data, data], axis=-1)[..., :4], impl="rbg"
    )


def _resolve_rng(key, sampler):
    """``sampler`` may carry an ``_rbg`` suffix selecting the ``rbg`` key
    impl; returns (possibly converted key, base sampler name)."""
    if sampler.endswith("_rbg"):
        return _to_rbg(key), sampler[: -len("_rbg")]
    return key, sampler


def _static_matmul(a, m):
    """``a[..., K] @ m[K, J]`` for a small static numpy matrix ``m``, as an
    unrolled sum over its nonzero entries: elementwise float32 multiply-adds,
    never a ``dot_general`` that a backend could run at reduced precision."""
    cols = []
    for j in range(m.shape[1]):
        acc = jnp.zeros(a.shape[:-1], a.dtype)
        for k in np.flatnonzero(m[:, j]):
            coef = float(m[k, j])
            acc = acc + (a[..., k] if coef == 1.0 else coef * a[..., k])
        cols.append(acc)
    return jnp.stack(cols, axis=-1)


def _per_capita(model, x, rates):
    """Per-capita hazards mu[r] = a_r / x[source[r]], NaN-proofed.  The clip
    matters: PMMH evaluates proposals unconditionally under vmap and discards
    negative-theta ones afterwards, so a garbage theta must not poison the
    chain with NaNs."""
    src_x = jnp.take(x, jnp.asarray(model.source), axis=-1)
    return jnp.where(src_x > 0, jnp.clip(rates, 0.0) / jnp.maximum(src_x, 1.0), 0.0)


def _exit_counts(model: CompartmentModel, key, x, mu, dt, binomial):
    """Sample per-reaction event counts for one substep given per-capita
    hazards ``mu [..., R]``.  x: [..., C] -> counts [..., R]."""
    src = jnp.asarray(model.source)

    if model.sources_unique:
        # one reaction per source compartment: sample each reaction directly
        src_x = jnp.take(x, src, axis=-1)  # [..., R]
        p_fire = jnp.clip(-jnp.expm1(-mu * dt), 0.0, 1.0)
        return binomial(key, src_x, p_fire)

    # Generic path: competing hazards — total exits per compartment, then
    # split among its reactions with conditional binomials (static unroll).
    onehot = np.eye(model.num_compartments)[model.source]  # [R, C]
    lam = _static_matmul(mu, onehot)  # [..., C] total per-capita exit hazard
    p_exit = jnp.clip(-jnp.expm1(-lam * dt), 0.0, 1.0)
    keys = jax.random.split(key, model.num_reactions + 1)
    n_exit = binomial(keys[0], x, p_exit)  # [..., C]

    counts = []
    remaining = n_exit
    rem_rate = lam
    src_list = model.source.tolist()
    for r in range(model.num_reactions):
        c = src_list[r]
        is_last = src_list[(r + 1):].count(c) == 0
        rem_c = remaining[..., c]
        if is_last:
            n_r = rem_c
        else:
            frac = jnp.clip(
                mu[..., r] / jnp.maximum(rem_rate[..., c], 1e-30), 0.0, 1.0
            )
            n_r = binomial(keys[r + 1], rem_c, frac)
        counts.append(n_r)
        remaining = remaining.at[..., c].add(-n_r)
        rem_rate = rem_rate.at[..., c].add(-mu[..., r])
    return jnp.stack(counts, axis=-1)


def draw_binomial(key, n, p, sampler="fast"):
    """Binomial(n, p) draws from the tau-leap sampler named ``sampler``
    (including the ``_rbg`` variants), for checking a sampler's law."""
    key, sampler = _resolve_rng(key, sampler)
    return get_binomial_sampler(sampler)(key, n, p)


def event_counts(model: CompartmentModel, key, x, theta, dt, sampler="fast"):
    """Per-reaction event counts ``[..., R]`` of one substep of length dt."""
    key, sampler = _resolve_rng(key, sampler)
    binomial = get_binomial_sampler(sampler)
    mu = _per_capita(model, x, model.rate_fn(x, theta))
    return _exit_counts(model, key, x, mu, dt, binomial)


def substep(model: CompartmentModel, key, x, theta, dt, sampler="fast"):
    """Advance the state by one tau-leap substep of length dt."""
    n_events = event_counts(model, key, x, theta, dt, sampler)  # [..., R]
    return x + _static_matmul(n_events, model.stoich)


@partial(jax.jit, static_argnums=(0, 4, 5, 6, 7))
def advance(
    model: CompartmentModel,
    key,
    x,
    theta,
    t_span,
    steps_per_unit=20,
    sampler="fast",
    unroll: int = 10,
):
    """Advance by ``t_span`` time units using ``t_span * steps_per_unit``
    substeps (scan with a modest unroll — see the module docstring).  Replaces the
    reference PF's per-particle joblib fan-out of one-unit Gillespie runs
    (reference pmcmc.py:200-220).  x: [..., C]."""
    n_steps = int(round(t_span * steps_per_unit))
    dt = t_span / n_steps
    key, sampler = _resolve_rng(key, sampler)

    def body(x, k):
        return substep(model, k, x, theta, dt, sampler), None

    keys = jax.random.split(key, n_steps)
    x_final, _ = jax.lax.scan(
        body, x, keys, unroll=min(unroll, n_steps)
    )
    return x_final


@partial(jax.jit, static_argnums=(0, 4, 5, 6))
def simulate(
    model: CompartmentModel,
    key,
    x0,
    theta,
    t_max,
    steps_per_unit=20,
    sampler="fast",
):
    """Simulate forward and record the state at integer times 0..t_max.

    Returns ``[t_max + 1, ..., C]`` (time-major).  This is the device
    equivalent of running the reference SSA with ``last_values_only=False``
    and aligning the event trajectory to the integer grid, as the ABC driver
    does by hand (reference abc_algo.py:55-93).
    """

    def unit(x, k):
        x_next = advance(model, k, x, theta, 1.0, steps_per_unit, sampler)
        return x_next, x_next

    keys = jax.random.split(key, int(t_max))
    _, traj = jax.lax.scan(unit, x0, keys)
    return jnp.concatenate([x0[None], traj], axis=0)
