"""ABC rejection sampling, vectorized on device.

The reference (reference abc_algo.py:17-109) draws one candidate at a time:
sample (beta, gamma) from uniform priors, Poisson-jitter the initial state,
run one Python-Gillespie trajectory, align it to the integer time grid by
hand (abc_algo.py:55-93), compute the distance, and retry until below
threshold.  Here a whole *batch* of candidates is simulated in one compiled
tau-leap sweep (daily states recorded directly — no alignment pass needed),
distances are computed on device INSIDE the same compiled program, and the
host loop:

  * syncs only the [K] distance vector per batch (the trajectories stay on
    device and are fetched only for accepted candidates);
  * double-buffers: the next batch is enqueued BEFORE the current batch's
    accepted rows are fetched, so host-side mask/accept bookkeeping overlaps
    device compute instead of serializing with every batch.

Acceptance bookkeeping matches the reference's live telemetry: total trials
and acceptance ratio (abc_algo.py:27-28, 108).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import CompartmentModel
from ..sim.tauleap import simulate


def reference_sir_distance(sim_traj, observed):
    """(mean |I_sim - I_obs| + mean |R_sim - R_obs|) / 2
    (reference abc_algo.py:10-13), batched over candidates.
    sim_traj: [T, K, C]; observed: [T, C] -> [K]."""
    d_i = jnp.mean(jnp.abs(sim_traj[:, :, 1] - observed[:, None, 1]), axis=0)
    d_r = jnp.mean(jnp.abs(sim_traj[:, :, 2] - observed[:, None, 2]), axis=0)
    return 0.5 * (d_i + d_r)


@dataclasses.dataclass
class ABCResult:
    """posterior: dict name -> [n_samples] accepted draws (the reference's
    ``posterior_distr`` dict, abc_algo.py:21); trajectories: [n_samples, T, C]
    accepted simulated trajectories; trials: total candidate count;
    acceptance_rate: n_samples / trials."""

    posterior: Dict[str, np.ndarray]
    trajectories: np.ndarray
    trials: int

    @property
    def acceptance_rate(self):
        return self.trajectories.shape[0] / max(self.trials, 1)


@partial(jax.jit, static_argnums=(0, 3))
def _abc_prep(model: CompartmentModel, key, observed, batch_size: int,
              lo, hi):
    """Sample a candidate batch: uniform-prior thetas + Poisson-jittered
    initial states (reference abc_algo.py:36-40) + an int32 simulation seed."""
    k_theta, k_init, k_sim = jax.random.split(key, 3)
    d = lo.shape[0]
    thetas = lo + (hi - lo) * jax.random.uniform(k_theta, (batch_size, d))
    x0 = jax.random.poisson(
        k_init, observed[0], shape=(batch_size,) + observed[0].shape
    ).astype(jnp.float32)
    seed = jax.random.randint(k_sim, (), 0, jnp.iinfo(jnp.int32).max)
    return thetas, x0, seed


@partial(jax.jit, static_argnums=(0, 3, 6, 7, 8))
def _abc_batch(
    model: CompartmentModel,
    key,
    observed,
    batch_size: int,
    lo,
    hi,
    t_max: int,
    steps_per_unit: int,
    distance_fn=None,
):
    """Vmapped substep-scan simulation + on-device distance, one compiled
    program.  Returns (thetas [K, d], sim [K, T, C], dist [K])."""
    thetas, x0, seed = _abc_prep(model, key, observed, batch_size, lo, hi)
    k_sim = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    sim = jax.vmap(
        lambda k, x, th: simulate(model, k, x, th, t_max, steps_per_unit),
        in_axes=(0, 0, 0),
    )(jax.random.split(k_sim, batch_size), x0, thetas)  # [K, T, C]
    dist = distance_fn(jnp.swapaxes(sim, 0, 1), observed)  # [K]
    return thetas, sim, dist


def abc_rejection(
    model: CompartmentModel,
    key,
    observed_data,
    n_samples: int,
    threshold: float,
    priors: Dict[str, tuple],
    distance_fn: Callable = reference_sir_distance,
    batch_size: int = 512,
    steps_per_unit: int = 20,
    max_trials: int = 10_000_000,
) -> ABCResult:
    """Drop-in capability match for ``abc_algo`` (reference abc_algo.py:17):
    ``priors`` maps parameter name -> (low, high) in the model's flat-theta
    order, e.g. ``{"beta": (0, 5), "gamma": (0, 5)}``.
    """
    observed = jnp.asarray(observed_data, jnp.float32)
    t_max = observed.shape[0] - 1
    names = list(priors.keys())
    lo = jnp.asarray([priors[n][0] for n in names], jnp.float32)
    hi = jnp.asarray([priors[n][1] for n in names], jnp.float32)

    def launch(key):
        key, k_batch = jax.random.split(key)
        return key, _abc_batch(
            model, k_batch, observed, batch_size, lo, hi, t_max,
            steps_per_unit, distance_fn,
        )

    acc_thetas, acc_trajs = [], []
    trials = 0
    n_accepted = 0
    key, pending = launch(key)
    while n_accepted < n_samples and trials < max_trials:
        thetas_d, sim_d, dist_d = pending
        # The distance sync blocks only until THIS batch's program finishes
        # (K floats; the device is busy computing it, not idle).  Deciding
        # continuation from it BEFORE enqueuing the next batch means the
        # final iteration launches nothing — no discarded overshoot batch
        # (round-3 advisor finding) — while the expensive bookkeeping below
        # (nonzero + full theta/trajectory fetches) still overlaps the next
        # batch's device compute whenever the loop does continue.
        mask = np.asarray(dist_d) <= threshold  # the only per-batch sync
        trials += batch_size
        n_found = int(mask.sum())
        if n_accepted + n_found < n_samples and trials < max_trials:
            key, pending = launch(key)  # double buffering
        if n_found:
            idx = np.nonzero(mask)[0]
            acc_thetas.append(np.asarray(thetas_d)[idx])
            acc_trajs.append(np.asarray(sim_d)[idx])
            n_accepted += n_found

    if n_accepted == 0:
        raise RuntimeError(
            f"ABC accepted nothing in {trials} trials at threshold {threshold}"
        )
    thetas = np.concatenate(acc_thetas)[:n_samples]
    trajs = np.concatenate(acc_trajs)[:n_samples]
    posterior = {n: thetas[:, j] for j, n in enumerate(names)}
    return ABCResult(posterior=posterior, trajectories=trajs, trials=trials)
