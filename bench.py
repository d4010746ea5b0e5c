"""Headline benchmark: PMMH aggregate throughput at 4096 particles (SIR).

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}.

Workload (BASELINE.json): PMMH on SIR with under-reported observations,
4096 particles per chain, T=15 observations, tau-leap propagation — the
reference's flagship configuration (reference tests/test_pmcmc_underreported.py
with n_particles scaled up).  Aggregate iters/s counts every parallel chain's
iteration; chains are vmapped on the card.  (The reference CPU
implementation manages ~0.02 iters/s at 100 particles:
tests/test_particles_subgroups.py:79-82.)

It measures the GPU.  With any other default backend it exits non-zero,
unless the caller set ``JAX_PLATFORMS=cpu`` itself: that run is a
rehearsal, and its numbers are labelled with the ``cpu`` platform.
"""
import json
import os
import sys
import time

import numpy as np


def _device_info():
    """The device the numbers belong to, or None when this is not a GPU run
    and not a CPU rehearsal the caller asked for."""
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if dev.platform == "gpu":
        from chip_smoke import gpu_name_and_power_limit

        info["name_power_limit"] = gpu_name_and_power_limit()
        return info
    if os.environ.get("JAX_PLATFORMS") == "cpu" and dev.platform == "cpu":
        return info
    return None


def main():
    import jax
    import jax.numpy as jnp

    import epitpu

    epitpu.enable_compilation_cache()
    device = _device_info()
    if device is None:
        print("bench.py measures a GPU; set JAX_PLATFORMS=cpu for a CPU "
              "rehearsal", file=sys.stderr)
        return 2
    from epitpu.cli.configs import ExperimentConfig
    from epitpu.cli.run import generate_dataset
    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model

    n_particles = 4096
    # 32 vmapped chains and the shapes below were chosen on an earlier
    # accelerator and have not been measured on the GPU.  "fast_rbg" draws
    # the tau-leap randomness through XLA's RngBitGenerator instead of
    # threefry — same trajectory law
    # (tests/test_sim.py::test_fast_rbg_sampler_matches_exact_moments).
    n_chains = int(os.environ.get("BENCH_CHAINS", "32"))
    n_iters = int(os.environ.get("BENCH_ITERS", "128"))
    # steps_per_unit=20 is an accuracy finding (it holds on any device):
    # the smallest substep count whose PF log-likelihood matched the
    # substeps=80 anchor (bias -0.003 log units); 10 substeps biased E[logZ]
    # by -0.66 and tilted the gamma posterior ~0.8 sd.
    steps_per_unit = int(os.environ.get("BENCH_STEPS_PER_UNIT", "20"))
    sampler = os.environ.get("BENCH_SAMPLER", "fast_rbg")
    resampling = os.environ.get("BENCH_RESAMPLING", "systematic")
    resample_threshold = float(os.environ.get("BENCH_RESAMPLE_THRESHOLD", "1.0"))
    # resample_every=4 is the production configuration: resampling every
    # 4th observation step with carried weights is an exactly-valid
    # pseudo-marginal PMMH (unbiased logZ estimator -> same posterior) that
    # skips the N^2 resampling work on the other steps.  Its speed on the
    # GPU has not been measured.  The reference-semantics number is
    # reported alongside as ref_iters_per_s / ref_ess_per_s.
    resample_every = int(os.environ.get("BENCH_RESAMPLE_EVERY", "4"))

    y, _ = generate_dataset(ExperimentConfig())  # the flagship data
    y = jnp.asarray(y)

    model = sir_model()
    obs = get_observation_model("binomial")

    def run(key, iters, adaptive=False, h=0.05, adapt_start=10**6,
            pooled=False, r_every=None):
        return particle_mcmc_chains(
            model,
            obs,
            key,
            y,
            jnp.array([2.0, 1.0]),
            h,
            n_chains=n_chains,
            n_iters=iters,
            obs_param=0.1,
            n_particles=n_particles,
            n_population=4820,
            mu=20.0,
            steps_per_unit=steps_per_unit,
            n_init_attempts=2,
            sampler=sampler,
            resampling=resampling,
            resample_threshold=resample_threshold,
            resample_every=resample_every if r_every is None else r_every,
            adaptive=adaptive,
            adapt_start=adapt_start,
            pooled_adaptation=pooled,
        )

    # warmup/compile with a tiny iteration count (same static config)
    r = run(jax.random.PRNGKey(0), n_iters)
    np.asarray(r.thetas)

    t0 = time.time()
    r = run(jax.random.PRNGKey(1), n_iters)
    np.asarray(r.thetas)
    elapsed = time.time() - t0

    total_iters = n_chains * n_iters
    iters_per_s = total_iters / elapsed

    # Secondary metric (BASELINE.md): ESS/s.  Geyer multi-chain ESS per theta
    # component over the timed chains (no burn-in: each chain starts at an
    # accepted init-search proposal drawn around theta_true, matching the
    # bench's steady-state intent); report the min component — the binding
    # constraint for posterior quality — divided by wall time.
    from epitpu.diag import ess, ess_rank

    thetas = np.asarray(r.thetas)  # [n_chains, n_iters, d] (init row + n_iters-1 scan rows)
    ess_components = ess(thetas)  # [d]
    ess_min = float(np.min(ess_components))
    ess_per_s = ess_min / elapsed
    ess_min_rank = float(np.min(ess_rank(thetas)))

    # TUNED ESS/s (BASELINE.md secondary metric): the proposal covariance
    # pooled across ALL vmapped chains via collectives (Welford, reference
    # pmcmc.py:327-328 upgraded with cross-chain pooling) engaging after 16
    # iterations, scale h=0.6 on the adapted covariance.  h=0.6 came from
    # a long-run study on an earlier accelerator (ESS/s is a property of
    # the chains, but per second it is not measured on the GPU).  The
    # section runs its own longer window (default 512 iters, burn 64): at
    # 128 iters the pooled covariance has not converged.
    tuned_kw = dict(adaptive=True, h=0.6, adapt_start=16, pooled=True)
    n_iters_tuned = int(os.environ.get("BENCH_TUNED_ITERS", "512"))
    if os.environ.get("BENCH_SKIP_TUNED"):
        tuned = {}
    else:
        r2 = run(jax.random.PRNGKey(0), n_iters_tuned, **tuned_kw)
        np.asarray(r2.thetas)  # warmup/compile
        t1 = time.time()
        r2 = run(jax.random.PRNGKey(1), n_iters_tuned, **tuned_kw)
        th2 = np.asarray(r2.thetas)
        elapsed2 = time.time() - t1
        burn2 = n_iters_tuned // 8
        ess2 = float(np.min(ess(th2[:, burn2:, :])))
        tuned = {
            "tuned_ess_per_s": round(ess2 / elapsed2, 2),
            "tuned_ess_min_component": round(ess2, 1),
            "tuned_iters_per_s": round(
                n_chains * n_iters_tuned / elapsed2, 2
            ),
            "tuned_iters": n_iters_tuned,
            "tuned_acceptance": round(
                float(np.asarray(r2.acceptances).mean()) / n_iters_tuned, 3
            ),
        }

    # EFFICIENT-ESS configuration: the CLI `production` preset's sampler
    # settings (2048 chains x 16 particles, pooled adaptation at h=0.6,
    # store_trajectories=False: no filter history, no path sampling, no
    # trajectory stacking).  The pseudo-marginal sampler is exact at any
    # N, so the particle count trades mixing against throughput; this
    # shape was the stable optimum of a chains x particles sweep on an
    # earlier accelerator and has not been re-swept on the GPU.  No
    # target-acceptance controller: at large chain counts it shrinks the
    # steps, and a rare badly-initialized chain then cannot walk home
    # within the window, collapsing min-component pooled ESS.
    # eff_ess_per_s is the PRIMARY ESS/s metric (duplicated as ess_per_s);
    # the 4096-particle baseline-shape number stays alongside as
    # baseline_ess_per_s.
    n_eff_particles = int(os.environ.get("BENCH_EFF_PARTICLES", "16"))
    n_eff_chains = int(os.environ.get("BENCH_EFF_CHAINS", "2048"))
    if os.environ.get("BENCH_SKIP_EFF"):
        eff = {}
    else:
        def run_eff(key, iters):
            return particle_mcmc_chains(
                model, obs, key, y, jnp.array([2.0, 1.0]), 0.6,
                n_chains=n_eff_chains, n_iters=iters, obs_param=0.1,
                n_particles=n_eff_particles, n_population=4820, mu=20.0,
                steps_per_unit=steps_per_unit, n_init_attempts=2,
                sampler=sampler, resampling=resampling,
                resample_every=resample_every, adaptive=True,
                adapt_start=16, pooled_adaptation=True,
                store_trajectories=False,
            )

        r4 = run_eff(jax.random.PRNGKey(0), n_iters_tuned)
        np.asarray(r4.thetas)  # warmup/compile
        # two timed reps, keep the faster wall (the least-interference
        # estimate under host scheduling noise)
        best = None
        for rep_key in (1, 2):
            t3 = time.time()
            r4 = run_eff(jax.random.PRNGKey(rep_key), n_iters_tuned)
            th4 = np.asarray(r4.thetas)
            elapsed4 = time.time() - t3
            if best is None or elapsed4 < best[0]:
                best = (elapsed4, th4, r4)
        elapsed4, th4, r4 = best
        burn4 = n_iters_tuned // 8
        ess4 = float(np.min(ess(th4[:, burn4:, :])))
        ess4_rank = float(np.min(ess_rank(th4[:, burn4:, :])))
        eff = {
            "eff_ess_per_s": round(ess4 / elapsed4, 2),
            # rank-normalized split variant alongside the classic one
            "eff_ess_rank_per_s": round(ess4_rank / elapsed4, 2),
            "eff_iters_per_s": round(
                n_eff_chains * n_iters_tuned / elapsed4, 2
            ),
            "eff_particles": n_eff_particles,
            "eff_chains": n_eff_chains,
            "eff_acceptance": round(
                float(np.asarray(r4.acceptances).mean()) / n_iters_tuned, 3
            ),
        }

    # reference always-resample semantics for comparison
    if os.environ.get("BENCH_SKIP_REF") or resample_every == 1:
        ref = {}
    else:
        r3 = run(jax.random.PRNGKey(0), n_iters, r_every=1)
        np.asarray(r3.thetas)
        t2 = time.time()
        r3 = run(jax.random.PRNGKey(1), n_iters, r_every=1)
        th3 = np.asarray(r3.thetas)
        elapsed3 = time.time() - t2
        ref = {
            "ref_iters_per_s": round(total_iters / elapsed3, 2),
            "ref_ess_per_s": round(float(np.min(ess(th3))) / elapsed3, 2),
        }

    out = {
        "metric": f"PMMH aggregate iters/s (SIR, {n_particles} particles, "
        f"T=15, {n_chains} chains/card, resample_every={resample_every})",
        "value": round(iters_per_s, 2),
        "unit": "iters/s",
        "device": device,
        # PRIMARY ESS/s = the `production` CLI preset's configuration;
        # baseline_* keeps the 4096-particle baseline-shape ESS/s.  null
        # when the eff section is skipped, rather than the baseline shape's
        # number under the same key
        "ess_per_s": eff.get("eff_ess_per_s"),
        "ess_rank_per_s": eff.get("eff_ess_rank_per_s"),
        "baseline_ess_per_s": round(ess_per_s, 2),
        "baseline_ess_min_component": round(ess_min, 1),
        "baseline_ess_min_rank": round(ess_min_rank, 1),
        "elapsed_s": round(elapsed, 3),
        **tuned,
        **eff,
        **ref,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
