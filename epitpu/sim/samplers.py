"""Fast batched binomial sampling for the tau-leap hot loop.

``jax.random.binomial`` runs a rejection sampler with a data-dependent
while_loop and computes both of its internal branches; on an earlier
accelerator it cost ~30x this sampler at production shapes and would have
dominated the PMMH iteration (not yet measured on the GPU).  The tau-leap
kernel only ever needs Binomial(n, p) where p is a small per-step hazard,
so a two-regime sampler covers it:

  * mean < SMALL_MEAN_MAX: EXACT inverse-CDF inversion.  The pmf is built by
    the stable recurrence pmf_{k+1} = pmf_k * (n-k)/(k+1) * p/(1-p), unrolled
    to K terms, and a single uniform is inverted through the CDF.  The only
    approximation is truncation at K: P(X >= 20 | mean <= 8) < 1e-4, i.e.
    ~1 in 10^4 draws clamps a tail count by a few units — far below the
    tau-leap dt bias.  (The unrolled CDF loop is the hottest arithmetic in
    the propagation phase; K=20 rather than 24 drops 4 negligible tail
    terms.)
  * mean >= SMALL_MEAN_MAX: normal approximation with a second-order
    Cornish-Fisher skewness correction, rounded and clamped to [0, n]; at
    mean >= 8 the CF-corrected quantile error is below the tau-leap dt bias.

Both branches cost one RNG draw + O(K) elementwise flops, fused by XLA.
``sampler="exact"`` falls back to jax.random.binomial for gold-standard
validation runs (and is what the test-suite oracle uses to check this one).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

SMALL_MEAN_MAX = 8.0
SMALL_K = 20  # CDF terms for the exact-inversion branch (see module doc)


def _binomial_small_exact(u, n, p):
    """Exact inverse-CDF for X ~ Binomial(n, p) truncated at SMALL_K.
    u: uniforms in [0,1); broadcastable with n, p."""
    p = jnp.clip(p, 0.0, 1.0 - 1e-7)
    q = 1.0 - p
    ratio = p / q
    log_pmf0 = n * jnp.log1p(-p)
    pmf = jnp.exp(log_pmf0)
    cdf = pmf
    x = jnp.zeros_like(u)
    for k in range(SMALL_K - 1):
        x = x + (u >= cdf).astype(u.dtype)  # count thresholds passed
        pmf = pmf * (n - k) / (k + 1.0) * ratio
        pmf = jnp.maximum(pmf, 0.0)  # (n-k) can go negative once k >= n
        cdf = cdf + pmf
    x = x + (u >= cdf).astype(u.dtype)
    return jnp.minimum(x, n)


def _binomial_normal_cf(z, n, p):
    """Cornish-Fisher corrected normal approximation, rounded + clamped."""
    lam = n * p
    var = lam * (1.0 - p)
    sig = jnp.sqrt(jnp.maximum(var, 1e-12))
    gamma = (1.0 - 2.0 * p) / sig  # skewness of the binomial
    zc = z + gamma * (z * z - 1.0) / 6.0
    x = jnp.floor(lam + sig * zc + 0.5)
    return jnp.clip(x, 0.0, n)


def fast_binomial(key, n, p):
    """Drop-in batched Binomial(n, p) sampler (float counts in, float counts
    out), accurate to well below tau-leap discretization error."""
    k_u, k_z = jax.random.split(key)
    shape = jnp.broadcast_shapes(jnp.shape(n), jnp.shape(p))
    n = jnp.broadcast_to(n, shape).astype(jnp.float32)
    p = jnp.clip(jnp.broadcast_to(p, shape).astype(jnp.float32), 0.0, 1.0)
    # flip to p <= 1/2 for normal-branch accuracy: X ~ n - Binomial(n, 1-p)
    flip = p > 0.5
    p_eff = jnp.where(flip, 1.0 - p, p)
    lam = n * p_eff

    u = jax.random.uniform(k_u, shape)
    z = jax.random.normal(k_z, shape)
    small = _binomial_small_exact(u, n, p_eff)
    large = _binomial_normal_cf(z, n, p_eff)
    x = jnp.where(lam < SMALL_MEAN_MAX, small, large)
    x = jnp.where(flip, n - x, x)
    # degenerate endpoints
    x = jnp.where(p == 0.0, 0.0, x)
    x = jnp.where(p == 1.0, n, x)
    return x


def exact_binomial(key, n, p):
    """jax.random.binomial with NaN-proofing (p outside [0,1] clamped),
    for validation runs."""
    p = jnp.clip(p, 0.0, 1.0)
    return jax.random.binomial(key, n, p).astype(jnp.float32)


_SAMPLERS = {"fast": fast_binomial, "exact": exact_binomial}


def get_binomial_sampler(name):
    try:
        return _SAMPLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown binomial sampler {name!r}; options {sorted(_SAMPLERS)}"
        ) from None
