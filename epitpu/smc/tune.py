"""Self-sizing particle counts — the pseudo-marginal tuning rule as code.

The PMMH posterior is exact at ANY particle count (the likelihood estimate
is unbiased), so N trades throughput against mixing only: the standard
tuning result (Doucet, Pitt, Deligiannidis & Kohn 2015; Sherlock et al.
2015) puts the efficiency optimum where the log-likelihood estimator's
standard deviation at a representative theta is ~1.0-1.7.  A chains x
particles sweep on an earlier accelerator (not yet repeated on the GPU)
agreed: ESS/s kept rising as N fell until sd(logZ) crossed ~1 (N=16 at
sd=0.71 was the stable peak for the flagship workload; N=8 at sd=1.6
went unstable), and the low-noise Gaussian levels need larger N because
their weights are sharper.

``tune_particles`` turns the rule into a measurement: double N until the
sampled sd(logZ) at the starting theta drops under ``target_sd``.  The
whole probe is a handful of vmapped filters, small next to the chain it
configures.  The reference has no counterpart: its
particle counts are hand-picked constants per script (reference
tests/experiments/noise/noise_.1.py:41 ``n_particles=100``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .filter import particle_filter


def tune_particles(
    model,
    obs_loglik,
    key,
    y,
    theta,
    obs_param,
    target_sd: float = 1.0,
    n_reps: int = 16,
    start: int = 16,
    max_particles: int = 4096,
    **filter_kwargs,
):
    """Smallest power-of-two multiple of ``start`` whose PF log-likelihood
    sd at ``theta`` is <= ``target_sd``.

    Returns ``(n_particles, sd)`` where ``sd`` is the measured estimator
    sd at the returned count.  If even ``max_particles`` misses the
    target, returns ``(max_particles, sd)`` — possibly ``inf`` — and the
    caller should surface that the rule was NOT satisfied (the CLI
    prints a warning); the posterior stays exact regardless, mixing is
    just slower.  Degenerate probes (non-finite logZ at this theta)
    force a doubling: more than one dead filter in ``n_reps`` means the
    estimator dies at the starting point too often to carry a chain, so
    the sd is treated as infinite rather than computed over the
    survivors (which would understate the noise exactly where it is
    worst).
    """
    n = int(start)
    keys = jax.random.split(key, n_reps)

    def sd_at(n_particles):
        f = partial(
            particle_filter,
            model,
            obs_loglik,
            y=y,
            theta=theta,
            obs_param=obs_param,
            n_particles=n_particles,
            record_history=False,
            **filter_kwargs,
        )
        lls = np.asarray(
            jax.jit(jax.vmap(lambda k: f(key=k).log_likelihood))(keys)
        )
        finite = np.isfinite(lls)
        if finite.sum() < n_reps - 1:
            return np.inf  # estimator dies too often at this N
        return float(lls[finite].std(ddof=1))

    while True:
        sd = sd_at(n)
        if sd <= target_sd or n >= max_particles:
            return n, sd
        n *= 2
