"""Device-mesh construction and sharded execution wrappers.

The reference has no distributed backend at all — its only parallelism is a
single-host joblib process pool over particles (reference pmcmc.py:8,
201-220) and chains run as separate script invocations combined post-hoc
(reference tests/test_pmcmc_noisy.py:254-267).  The device-native
equivalents:

  * particles: vectorized within a device (the tau-leap is batched) and
    optionally sharded over a ``particle`` mesh axis with psum/all_gather
    collectives inside the filter (epitpu.smc.filter ``axis_name``) — both
    standalone (``sharded_particle_filter``) and inside the PMMH step
    itself (``sharded_pmmh`` on a mesh with particle shards);
  * chains: embarrassingly parallel over a ``chain`` mesh axis via
    ``shard_map`` + per-device ``vmap``, with optional *pooled* adaptive
    covariance via collectives (epitpu.mcmc.adaptive.Welford.pooled) — a
    capability the reference lacks;
  * multi-host: the same mesh spans hosts once
    ``epitpu.dist.multihost.initialize_multihost()`` has joined the runtime
    (CLI: ``--multihost``); keep particle shards within a host, where NVLink
    carries their per-step collectives, and spread chain shards across
    hosts.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..mcmc.pmmh import particle_mcmc
from ..smc.filter import particle_filter

CHAIN_AXIS = "chain"
PARTICLE_AXIS = "particle"


def make_mesh(
    n_chain_shards: Optional[int] = None,
    n_particle_shards: int = 1,
    devices=None,
) -> Mesh:
    """Build a ``(chain, particle)`` mesh.  Defaults to all visible devices
    on the chain axis (chains are the scalable resource for PMMH — MCMC
    iterations are inherently sequential, SURVEY.md section 7)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_chain_shards is None:
        n_chain_shards = devices.size // n_particle_shards
    need = n_chain_shards * n_particle_shards
    if need > devices.size:
        raise ValueError(
            f"mesh needs {need} devices "
            f"({n_chain_shards} chain x {n_particle_shards} particle shards) "
            f"but only {devices.size} are available"
        )
    grid = devices.reshape(-1)[:need].reshape(n_chain_shards, n_particle_shards)
    return Mesh(grid, (CHAIN_AXIS, PARTICLE_AXIS))


def sharded_particle_filter(
    mesh: Mesh,
    model,
    obs_loglik,
    key,
    y,
    theta,
    obs_param,
    n_particles_total: int,
    **kwargs,
):
    """Particle filter with the particle axis sharded over the mesh.

    ``n_particles_total`` is the GLOBAL particle count; each of the
    ``particle`` shards owns ``n_particles_total / P`` particles.  Returns a
    FilterResult whose ``log_likelihood`` is replicated; ``hidden`` stays
    sharded over particles (axis 1).
    """
    n_shards = mesh.shape[PARTICLE_AXIS]
    if n_particles_total % n_shards:
        raise ValueError(
            f"n_particles_total={n_particles_total} not divisible by "
            f"{n_shards} particle shards"
        )
    n_local = n_particles_total // n_shards

    def body(key, y, theta, obs_param):
        return particle_filter(
            model,
            obs_loglik,
            key,
            y,
            theta,
            obs_param,
            n_particles=n_local,
            axis_name=PARTICLE_AXIS,
            **kwargs,
        )

    # log_likelihood/log_zetas/degenerate are replicated; hidden and ancestry
    # stay sharded on the particle axis (axis 1)
    from ..smc.filter import FilterResult

    out_specs = FilterResult(
        log_likelihood=P(),
        log_zetas=P(),
        hidden=P(None, PARTICLE_AXIS, None),
        ancestry=P(None, PARTICLE_AXIS),
        degenerate=P(),
        final_logw=P(PARTICLE_AXIS),
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)(key, y, theta, obs_param)


def sharded_pmmh(
    mesh: Mesh,
    model,
    obs_loglik,
    key,
    y,
    parameters,
    h,
    n_chains_total: int,
    pooled_adaptation: bool = False,
    return_shard_check: bool = False,
    **kwargs,
):
    """Run ``n_chains_total`` independent PMMH chains sharded over the
    ``chain`` mesh axis, ``vmap``-ped within each device.

    When the mesh has a particle axis with more than one shard, each chain's
    ``n_particles`` (the GLOBAL per-chain particle count, from ``kwargs``)
    is split across it and the filter INSIDE the PMMH step runs its weight
    normalization / resampling with psum + all_gather collectives over that
    axis (``epitpu.smc.filter`` ``axis_name``); the ancestral path sampler
    consumes the all-gathered history (``epitpu.mcmc.pmmh
    ._filter_ll_and_path``).  This is what makes a (chain x particle) mesh
    real for PMMH — the device-native scale-out of the reference's per-particle
    joblib pool (reference pmcmc.py:200-220) along BOTH axes at once.

    Result arrays have a leading global chains axis (sharded; replicated
    along the particle axis).  With ``pooled_adaptation`` the adaptive
    proposal covariance pools Welford statistics across ALL chains via
    collectives each iteration.

    ``return_shard_check=True`` additionally returns the theta chains
    all-gathered over the PARTICLE axis, shape ``[p_shards, chains, rows,
    d]`` — every particle shard of a chain must hold the bit-identical
    chain state (the replication invariant the design depends on: chain
    keys are replicated along the particle axis, only the filter's cloud is
    sharded).  A misplaced collective breaks exactly this;
    ``__graft_entry__.dryrun_multichip`` asserts it on every run.
    """
    n_shards = mesh.shape[CHAIN_AXIS]
    if n_chains_total % n_shards:
        raise ValueError(
            f"n_chains_total={n_chains_total} not divisible by "
            f"{n_shards} chain shards"
        )
    n_local = n_chains_total // n_shards
    pool_axes = ("chain_vmap", CHAIN_AXIS) if pooled_adaptation else ()

    p_shards = mesh.shape.get(PARTICLE_AXIS, 1)
    if p_shards > 1:
        if "n_particles" not in kwargs:
            # don't duplicate particle_mcmc's default here: a silent
            # fallback would make an n_particles-omitting sharded call
            # diverge from the unsharded meaning if that default ever
            # changes (round-4 advisor finding)
            raise ValueError(
                "sharded_pmmh on a mesh with particle shards requires an "
                "explicit n_particles (the GLOBAL per-chain particle count "
                "to split across the particle axis)"
            )
        n_particles_total = kwargs.pop("n_particles")
        if n_particles_total % p_shards:
            raise ValueError(
                f"n_particles={n_particles_total} not divisible by "
                f"{p_shards} particle shards"
            )
        kwargs["n_particles"] = n_particles_total // p_shards
        kwargs["filter_axis_name"] = PARTICLE_AXIS

    def body(keys):
        # keys: [n_local, 2] local slice of per-chain keys (replicated
        # along the particle axis: every particle shard of a chain sees the
        # same chain key, so proposals/accepts are replicated and only the
        # filter's particle cloud is sharded)
        run = lambda k: particle_mcmc(
            model,
            obs_loglik,
            k,
            y,
            parameters,
            h,
            pool_axes=pool_axes,
            **kwargs,
        )
        res = jax.vmap(run, axis_name="chain_vmap")(keys)
        if return_shard_check:
            per_shard = jax.lax.all_gather(res.thetas, PARTICLE_AXIS)
            return res, per_shard
        return res

    keys = jax.random.split(key, n_chains_total)
    out_specs = (
        (P(CHAIN_AXIS), P(None, CHAIN_AXIS))
        if return_shard_check
        else P(CHAIN_AXIS)
    )
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(CHAIN_AXIS),),
        out_specs=out_specs,
        check_vma=False,
    )
    if jax.process_count() > 1:
        # multi-process run (mesh spans hosts): every process computes the
        # same full key table, then assembles the GLOBAL sharded array from
        # its addressable slice — jit cannot auto-shard a host-local array
        # across processes (tests/test_multiprocess.py executes this path
        # with 2 OS processes over Gloo)
        keys_np = np.asarray(keys)
        sharding = NamedSharding(mesh, P(CHAIN_AXIS))
        keys = jax.make_array_from_callback(
            keys_np.shape, sharding, lambda idx: keys_np[idx]
        )
    return jax.jit(fn)(keys)
