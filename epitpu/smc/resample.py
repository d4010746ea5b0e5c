"""Particle resampling kernels (log-weight in, ancestor indices out).

The reference resamples multinomially via ``np.random.choice`` on normalized
linear weights and aborts the whole filter on a ValueError when the weights
are NaN/degenerate (reference pmcmc.py:185-193).  Here:

  * weights stay in log space and are normalized with logsumexp;
  * ancestor indices come from a **fused compare-reduce** instead of
    searchsorted:  ``anc[j] = sum_k 1[cdf_k < p_j]``.  XLA fuses the
    broadcast-compare into the reduction, so the N x N comparison never
    materializes; it runs as elementwise streaming.  On an earlier
    accelerator a vmapped ``jnp.searchsorted`` + ``jnp.take`` inside the
    filter's scan was two orders of magnitude slower than this form.  The
    O(N^2) compares lose to the O(N) counts+scatter inversion past a
    crossover N, so ``systematic`` AUTO-DISPATCHES to the scatter path at
    ``n >= SCATTER_THRESHOLD_N`` — same ancestor assignment either way
    (see ``systematic_resample_scatter``), purely a kernel choice.  None
    of these speeds has been measured on the GPU yet
    (``scaling_bench.py --resampler`` measures the crossover);
  * "systematic" (default) is the lower-variance stratified scheme: a single
    uniform offset + N equally spaced points through the CDF;
  * "multinomial" reproduces the reference's scheme (N iid categorical
    draws), same compare-reduce, iid uniform points;
  * degeneracy never aborts: a degenerate step yields identity ancestry and a
    flag; the caller propagates -inf log-likelihood so PMMH rejects the
    proposal, matching the reference's reject-on-failure semantics
    (reference pmcmc.py:365-369).

Everything is shape-static and vmap/shard-friendly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp


def normalized_weights(logw):
    """Returns (weights [N], log_sum, degenerate).  Degenerate means no
    particle has finite weight; weights then fall back to uniform so
    downstream code stays NaN-free."""
    lse = logsumexp(logw, axis=-1)
    degenerate = ~jnp.isfinite(lse)
    w = jnp.exp(logw - jnp.where(degenerate, 0.0, lse)[..., None])
    n = logw.shape[-1]
    w = jnp.where(degenerate[..., None], jnp.ones_like(w) / n, w)
    return w, lse, degenerate


def _safe_cdf(logw):
    """Unnormalized linear-space CDF of the log-weights, max-shifted for
    stability.  Returns (cdf [..., N], degenerate [...]).  No division:
    resampling points are scaled by the total instead (saves a full-array
    divide and is exactly equivalent)."""
    m = jnp.max(logw, axis=-1, keepdims=True)
    degenerate = ~jnp.isfinite(m[..., 0])
    w = jnp.exp(logw - jnp.where(jnp.isfinite(m), m, 0.0))
    w = jnp.where(degenerate[..., None], 1.0, w)  # uniform fallback
    return jnp.cumsum(w, axis=-1), degenerate


def _compare_reduce_ancestors(cdf, points):
    """anc[..., j] = #{k : cdf[..., k] < points[..., j]} via a broadcast
    compare fused into a sum — no searchsorted, no gather.

    An exact two-level blocked decomposition (compare block maxima, gather
    each point's straddling block, compare within — 32.8x fewer compares
    at N=4096) benchmarked end-to-end slower on an earlier accelerator,
    where gathers serialized; it has not been tried on the GPU.  The
    resampling cost lever that needs no kernel is skipping steps
    (``resample_every`` / ``resample_threshold`` in epitpu.smc.filter)."""
    n = cdf.shape[-1]
    anc = jnp.sum(
        (cdf[..., None, :] < points[..., :, None]).astype(jnp.int32), axis=-1
    )
    return jnp.minimum(anc, n - 1)


# Smallest particle count at which the O(N) counts+scatter inversion beat
# the O(N^2) compare-reduce end-to-end on an earlier accelerator; not yet
# measured on the GPU (``scaling_bench.py --resampler``).
# ``systematic_resample`` switches kernels here — the ancestor assignment
# is identical either way.
SCATTER_THRESHOLD_N = 16384


def systematic_resample(key, logw):
    """Systematic resampling: points (i + u)/N for one u ~ U[0,1).

    Dispatches to the O(N) scatter kernel at ``n >= SCATTER_THRESHOLD_N``
    (a static shape decision, resolved at trace time); both kernels draw
    the same single uniform and produce the same ancestor assignment away
    from measure-zero CDF boundary ties
    (tests/test_resample.py::test_scatter_systematic_matches_compare_reduce).
    """
    n = logw.shape[-1]
    if n >= SCATTER_THRESHOLD_N:
        return systematic_resample_scatter(key, logw)
    cdf, degenerate = _safe_cdf(logw)
    total = cdf[..., -1:]
    u = jax.random.uniform(key, shape=logw.shape[:-1] + (1,))
    points = (jnp.arange(n, dtype=logw.dtype) + u) * (total / n)
    idx = _compare_reduce_ancestors(cdf, points)
    iota = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), idx.shape)
    return jnp.where(degenerate[..., None], iota, idx), degenerate


def multinomial_resample(key, logw):
    """N iid categorical draws — the reference's ``np.random.choice``
    (reference pmcmc.py:188-190) — via compare-reduce against iid uniforms."""
    n = logw.shape[-1]
    cdf, degenerate = _safe_cdf(logw)
    total = cdf[..., -1:]
    u = jax.random.uniform(key, shape=logw.shape[:-1] + (n,))
    idx = _compare_reduce_ancestors(cdf, u * total)
    iota = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), idx.shape)
    return jnp.where(degenerate[..., None], iota, idx), degenerate


def _offsets_to_ancestors(offsets, n):
    """Invert offspring offsets into ancestor indices in O(N).

    ``offsets[k]`` is the exclusive prefix sum of offspring counts (the first
    output slot owned by ancestor k); ancestor k fills slots
    ``[offsets[k], offsets[k+1])``.  Scatter a 1 at every ``offsets[k]``
    (zero-count ancestors collide harmlessly on the same slot; trailing
    ``offsets[k] == n`` are dropped), then ``cumsum - 1`` recovers, at each
    slot j, the largest k with ``offsets[k] <= j`` — which is exactly the
    positive-count ancestor owning slot j."""
    d = jnp.zeros((n,), jnp.int32).at[offsets].add(1, mode="drop")
    return jnp.cumsum(d) - 1


def systematic_resample_scatter(key, logw):
    """Systematic resampling in O(N) — no N x N broadcast.

    The compare-reduce above streams N^2 comparisons; at N=4096 that is
    16.8M compares per chain per filter step.  Systematic points
    ``p_j = (j + u) * total / N`` are already sorted, so the ancestor
    assignment is fully determined by the counts
    ``q(v) = #{j : p_j < v} = clip(ceil(v * N / total - u), 0, N)``
    evaluated at the CDF — an elementwise O(N) computation — and the
    counts invert to indices with one scatter + cumsum
    (``_offsets_to_ancestors``).  Same distribution as
    ``systematic_resample`` (boundary ties ``p_j == cdf_k`` resolve to the
    other side — a measure-zero event).  Batch dims vmap-expand.

    ``systematic_resample`` AUTO-DISPATCHES here at
    ``n >= SCATTER_THRESHOLD_N``; below that it remains the opt-in
    ``resampling="systematic_scatter"``."""
    n = logw.shape[-1]
    cdf, degenerate = _safe_cdf(logw)
    total = cdf[..., -1:]
    u = jax.random.uniform(key, shape=logw.shape[:-1] + (1,))
    q = jnp.clip(
        jnp.ceil(cdf * (n / total) - u), 0.0, float(n)
    ).astype(jnp.int32)  # [..., N] points strictly below each cdf value
    offsets = jnp.concatenate(
        [jnp.zeros_like(q[..., :1]), q[..., :-1]], axis=-1
    )
    if logw.ndim == 1:
        idx = _offsets_to_ancestors(offsets, n)
    else:
        flat = offsets.reshape(-1, n)
        idx = jax.vmap(_offsets_to_ancestors, in_axes=(0, None))(flat, n)
        idx = idx.reshape(offsets.shape)
    iota = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), idx.shape)
    return jnp.where(degenerate[..., None], iota, idx), degenerate


_RESAMPLERS = {
    "systematic": systematic_resample,
    "systematic_scatter": systematic_resample_scatter,
    "multinomial": multinomial_resample,
}


def get_resampler(kind):
    try:
        return _RESAMPLERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown resampling kind {kind!r}; options: {sorted(_RESAMPLERS)}"
        ) from None
