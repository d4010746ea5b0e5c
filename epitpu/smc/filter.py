"""Bootstrap particle filter as a single fused ``lax.scan`` over time.

Device-native redesign of the reference filter (reference pmcmc.py:123-233),
which runs a sequential Python loop over observation times and fans each
particle's one-unit Gillespie propagation out to a joblib process pool
(reference pmcmc.py:200-220).  Here the whole filter — weighting,
log-likelihood accumulation, resampling, ancestor gather, and tau-leap
propagation of the full particle cloud — is one scan body compiled by XLA,
with no host round-trips.  The filter is vmap-able over a chains axis and
shard_map-able over the particle axis (see epitpu.dist).

Reference timing semantics preserved exactly (reference pmcmc.py:177-183):
at step p (1..T-1) the weights compare observation ``Y[p-1]`` against the
*pre-propagation* states from step p-1, so ``Y[T-1]`` never enters the
likelihood; the marginal-likelihood estimate is
``zeta_p = zeta_{p-1} * mean(weights_p)`` — here accumulated in log space as
``logZ += logsumexp(logw) - log N``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from ..models.base import CompartmentModel
from ..sim.tauleap import advance
from .resample import get_resampler


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FilterResult:
    """Mirrors the reference's ``(zetas, hidden_process, ancestry_matrix)``
    triple (reference pmcmc.py:233), in log space and always shape-static.

    log_likelihood: scalar log of the reference's ``zetas[-1]``; -inf when any
      step degenerated (the reference returns ``(None, None, None)`` instead).
    log_zetas: [T] running log marginal likelihood (``log zetas``).
    hidden: [T, N, C] particle states; row 0 is the initial cloud.
    ancestry: [T, N] int32 ancestor indices; row 0 is zeros (never written by
      the reference either, pmcmc.py:152).
    degenerate: scalar bool — True iff some step had no finite weight.
    """

    log_likelihood: jnp.ndarray
    log_zetas: jnp.ndarray
    hidden: jnp.ndarray
    ancestry: jnp.ndarray
    degenerate: jnp.ndarray
    # [N] normalized terminal log-weights (global logsumexp == 0).  Uniform
    # (-log N) under always-resample semantics (resample_threshold >= 1);
    # with ESS-triggered conditional resampling they carry the residual
    # weights of the final step, and the path sampler's terminal draw must
    # use them to stay unbiased.
    final_logw: jnp.ndarray


def particle_filter(
    model: CompartmentModel,
    obs_loglik,
    key,
    y,
    theta,
    obs_param,
    n_particles: int = 1000,
    n_population=4820,
    mu=20.0,
    steps_per_unit: int = 20,
    resampling: str = "systematic",
    x0: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
    sampler: str = "fast",
    resample_threshold: float = 1.0,
    resample_every: int = 1,
    record_history: bool = True,
) -> FilterResult:
    """Run the bootstrap filter on observations ``y: [T, obs_dim]``.

    ``record_history=False`` (static) skips the per-step stacking of the
    particle history: ``hidden`` collapses to the initial cloud
    ``[1, N, C]`` and ``ancestry`` to a ``[1, N]`` zero row.  Resampling,
    weighting, and the log-likelihood are unchanged (bit-identical key
    stream) — this is the theta-only fast path for PMMH runs that never
    sample an ancestral trajectory (``particle_mcmc(...,
    store_trajectories=False)``); the reference has no equivalent switch,
    its filter always materializes ``hidden_process``/``ancestry_matrix``
    (reference pmcmc.py:146-152).

    ``theta`` is the model's flat parameter vector; ``obs_param`` the (traced)
    observation parameter (reporting probability or noise level).  ``x0`` may
    override the model's Poisson initial cloud (reference pmcmc.py:156-170).

    ``resample_threshold`` (alpha) enables ESS-triggered *conditional*
    resampling, the standard SMC variance-reduction absent from the
    reference (which resamples every step, reference pmcmc.py:185-193):
    resample only when the normalized-weight effective sample size drops
    below ``alpha * n_total``; otherwise keep identity ancestry and carry
    the normalized log-weights into the next step's weighting.  ``alpha >=
    1.0`` (default) is the reference's always-resample semantics, kept
    bit-identical to round-2 behavior.  Both settings are unbiased
    estimators of the marginal likelihood; conditional resampling lowers
    its variance and skips the resampling work statistically wasted on
    healthy particle clouds.

    ``resample_every`` (k) is the STATIC variant: resample only on every
    k-th observation step (weights carried between, same unbiased
    weight-carry estimator).  Because the schedule is a function of the
    step index — un-batched under the chains vmap — the skip is a real
    ``lax.cond``: skipped steps do NOT execute the O(N^2) compare-reduce
    (about half of the always-resample PMMH iteration in a device trace on
    an earlier accelerator; not yet measured on the GPU), which the
    data-dependent ESS trigger cannot avoid under
    vmap (batched predicate -> select executes both branches).  Composes
    with ``resample_threshold``: on scheduled steps the ESS gate still
    applies.

    ``axis_name`` enables particle-axis sharding inside ``shard_map``: each
    device holds ``n_particles`` *local* particles, the weight normalization
    uses a psum-logsumexp over the axis, and resampling all-gathers the (tiny)
    weight and state arrays so every shard computes the identical global
    ancestor assignment and keeps its own slice.  At epidemic-model sizes
    (N*C a few tens of KB) the all-gather is cheap; ancestry/hidden
    are recorded per-shard in *global* particle indices so a path sampled
    from the all-gathered history is genealogy-consistent.
    """
    resampler = get_resampler(resampling)
    t_len = y.shape[0]
    key_init, key_scan = jax.random.split(key)

    if axis_name is None:
        n_total = n_particles
        shard_offset = 0
        # fold in a zero "shard index" so the unsharded filter consumes the
        # EXACT key stream of a 1-shard sharded run — sharded(P=1) is then
        # bit-identical to unsharded, which tests/test_dist.py asserts
        shard_index = jnp.asarray(0, jnp.int32)
        key_init = jax.random.fold_in(key_init, shard_index)
    else:
        n_shards = jax.lax.psum(1, axis_name)
        n_total = n_particles * n_shards
        shard_index = jax.lax.axis_index(axis_name)
        shard_offset = shard_index * n_particles
        # shards share the caller's key (so the resampling stream is identical
        # everywhere) but must diversify their init/propagation randomness
        key_init = jax.random.fold_in(key_init, shard_index)
    log_n = jnp.log(jnp.asarray(n_total, jnp.float32))

    with jax.named_scope("pf_init"):
        if x0 is None:
            x0 = model.init_fn(key_init, n_particles, n_population, mu)
        x0 = x0.astype(jnp.float32)

    def _global_lse(logw):
        if axis_name is None:
            return logsumexp(logw)
        m = jax.lax.pmax(jnp.max(logw), axis_name)
        m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
        s = jax.lax.psum(jnp.sum(jnp.exp(logw - m_safe)), axis_name)
        return jnp.where(jnp.isfinite(m), jnp.log(s) + m_safe, -jnp.inf)

    def _global_sum(v):
        s = jnp.sum(v)
        return s if axis_name is None else jax.lax.psum(s, axis_name)

    def _do_resample(k_res, logw_for_res, x):
        """(ancestors in GLOBAL particle ids, resampled local states)."""
        if axis_name is None:
            anc, _ = resampler(k_res, logw_for_res)  # [N] int32
            return anc, jnp.take(x, anc, axis=0)
        logw_all = jax.lax.all_gather(
            logw_for_res, axis_name, tiled=True
        )  # [Ntot]
        x_all = jax.lax.all_gather(x, axis_name, tiled=True)  # [Ntot, C]
        anc_all, _ = resampler(k_res, logw_all)  # [Ntot] global ids
        anc = jax.lax.dynamic_slice_in_dim(anc_all, shard_offset, n_particles)
        return anc, jnp.take(x_all, anc, axis=0)

    conditional = resample_threshold < 1.0
    scheduled_mode = resample_every > 1
    carry_weights = conditional or scheduled_mode
    iota_global = shard_offset + jnp.arange(n_particles, dtype=jnp.int32)

    def _resample_branch(opr):
        k_res, lw_new, x, step_degen = opr
        anc_r, x_r = _do_resample(k_res, lw_new, x)
        if conditional:
            ess = 1.0 / _global_sum(jnp.exp(2.0 * lw_new))
            need = (ess < resample_threshold * n_total) & ~step_degen
        else:
            need = ~step_degen
        anc = jnp.where(need, anc_r, iota_global)
        x_res = jnp.where(need, x_r, x)
        lw_next = jnp.where(need, jnp.full_like(lw_new, -log_n), lw_new)
        return anc, x_res, lw_next

    def _skip_branch(opr):
        _, lw_new, x, _ = opr
        return iota_global, x, lw_new

    def step(carry, inp):
        x, lw, log_z, degen = carry
        y_t, k, scheduled = inp
        k_res, k_prop = jax.random.split(k)

        with jax.named_scope("pf_weight"):
            x_obs = model.observe_map(x)  # [N, obs_dim]
            logw = obs_loglik(y_t, x_obs, obs_param)  # [N]
        if not carry_weights:
            # always-resample (reference semantics); bit-identical to the
            # pre-threshold implementation
            with jax.named_scope("pf_loglik"):
                step_lse = _global_lse(logw)
                step_degen = ~jnp.isfinite(step_lse)
                log_z = jnp.where(
                    step_degen, -jnp.inf, log_z + step_lse - log_n
                )
            with jax.named_scope("pf_resample"):
                anc, x_res = _do_resample(k_res, logw, x)
            lw_next = lw  # stays uniform
        else:
            # carry normalized log-weights; increment is logsumexp of the
            # weighted mixture (reduces to logsumexp(logw) - log N whenever
            # the previous step resampled)
            with jax.named_scope("pf_loglik"):
                s = lw + logw
                step_lse = _global_lse(s)
                step_degen = ~jnp.isfinite(step_lse)
                log_z = jnp.where(step_degen, -jnp.inf, log_z + step_lse)
                lw_new = jnp.where(step_degen, -log_n, s - step_lse)
            opr = (k_res, lw_new, x, step_degen)
            with jax.named_scope("pf_resample"):
                if scheduled_mode:
                    # `scheduled` is a function of the step index only —
                    # UN-batched under the chains vmap — so this stays a
                    # true conditional and skipped steps skip the compare-
                    # reduce entirely
                    anc, x_res, lw_next = jax.lax.cond(
                        scheduled, _resample_branch, _skip_branch, opr
                    )
                else:
                    anc, x_res, lw_next = _resample_branch(opr)
        k_prop = jax.random.fold_in(k_prop, shard_index)
        with jax.named_scope("pf_propagate"):
            x_new = advance(
                model, k_prop, x_res, theta, 1.0, steps_per_unit, sampler
            )
        out = (x_new, anc, log_z) if record_history else (log_z,)
        return (x_new, lw_next, log_z, degen | step_degen), out

    keys = jax.random.split(key_scan, t_len - 1)
    # resample on every k-th observation step (p = 0 is the first scan step)
    schedule = (jnp.arange(1, t_len) % resample_every) == 0
    lw0 = jnp.full((n_particles,), -log_n, jnp.float32)
    init = (x0, lw0, jnp.asarray(0.0, jnp.float32), jnp.asarray(False))
    # the pf_scan scope catches the scan's own carry/stacking bookkeeping
    # (dynamic-update-slice of hidden/ancestry history) in profile
    # attribution; every op inside the body keeps its finer pf_* scope
    with jax.named_scope("pf_scan"):
        (_, lw_final, log_z, degen), outs = jax.lax.scan(
            step, init, (y[: t_len - 1], keys, schedule)
        )

    if record_history:
        xs, ancs, log_zs = outs
        hidden = jnp.concatenate([x0[None], xs], axis=0)
        ancestry = jnp.concatenate(
            [jnp.zeros((1, n_particles), jnp.int32), ancs], axis=0
        )
    else:
        (log_zs,) = outs
        hidden = x0[None]
        ancestry = jnp.zeros((1, n_particles), jnp.int32)
    log_zetas = jnp.concatenate([jnp.zeros((1,), jnp.float32), log_zs], axis=0)
    return FilterResult(
        log_likelihood=log_z,
        log_zetas=log_zetas,
        hidden=hidden,
        ancestry=ancestry,
        degenerate=degen,
        final_logw=lw_final,
    )


@partial(jax.jit, static_argnums=(0, 1, 6, 9, 10, 11, 12, 13))
def particle_filter_jit(
    model,
    obs_loglik,
    key,
    y,
    theta,
    obs_param,
    n_particles=1000,
    n_population=4820,
    mu=20.0,
    steps_per_unit=20,
    resampling="systematic",
    sampler="fast",
    resample_threshold=1.0,
    resample_every=1,
):
    return particle_filter(
        model,
        obs_loglik,
        key,
        y,
        theta,
        obs_param,
        n_particles=n_particles,
        n_population=n_population,
        mu=mu,
        steps_per_unit=steps_per_unit,
        resampling=resampling,
        sampler=sampler,
        resample_threshold=resample_threshold,
        resample_every=resample_every,
    )
