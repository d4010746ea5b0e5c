"""Chain-scaling efficiency harness -> SCALING.json.

BASELINE.md demands >= 80% scaling efficiency from 1 device to N hosts for
the chain-parallel PMMH path (``epitpu.dist.sharded_pmmh``).  This harness
measures the two components of that claim:

1. **Weak scaling over the chain mesh axis** on a virtual 8-device CPU mesh
   (``--xla_force_host_platform_device_count``): W shards x C chains/shard,
   fixed per-shard work.  Two efficiencies are reported per width:

   * ``wall``: T_wall(1) / T_wall(w) — the classic weak-scaling number.
     Only meaningful up to the PHYSICAL core count (this host has very few
     cores; virtual devices beyond that are time-sliced, so wall efficiency
     necessarily degrades ~linearly past it through no fault of the sharding).
   * ``cpu``: w * T_cpu(1) / T_cpu(w) where T_cpu is total process CPU time —
     measures the *extra work* introduced by shard_map + collectives
     (psum-pooled adaptation, weight psums) independent of core
     oversubscription.  This is the number the >= 80% assertion targets on
     a CPU host; on real devices wall == cpu because shards own whole
     devices.

2. **GPU modes** (``--chip``, ``--resampler``, ``--large-regime``): the
   chains-per-card throughput sweep, the resampler crossover and the
   population-10^6 bench.  They refuse any backend but a GPU and record the
   card's name and power limit beside their numbers.

Usage:
    JAX_PLATFORMS=cpu python scaling_bench.py   # virtual-mesh weak scaling
    python scaling_bench.py --chip               # on-card chain-count sweep
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

WIDTHS = (1, 2, 4, 8)


def _dataset():
    import jax.numpy as jnp

    from epitpu.cli.configs import ExperimentConfig
    from epitpu.cli.run import generate_dataset

    y, _ = generate_dataset(ExperimentConfig())  # the flagship data
    return jnp.asarray(y)


def _gpu_info():
    """The card the numbers belong to; raises SystemExit off a GPU."""
    import jax

    from chip_smoke import gpu_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"this mode measures a GPU, not {dev.platform!r}")
    return {"kind": dev.device_kind, "count": len(jax.devices()),
            "name_power_limit": gpu_name_and_power_limit()}


def _cpu_seconds():
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def weak_scaling(widths=WIDTHS, chains_per_shard=2, n_iters=48,
                 n_particles=256, steps_per_unit=10, repeats=3,
                 store_trajectories=True, mode="weak_scaling_chain_axis"):
    """Weak-scale sharded_pmmh over the chain mesh axis.  Returns the
    measurement dict (also what SCALING.json stores)."""
    import jax
    import jax.numpy as jnp

    from epitpu.dist import make_mesh, sharded_pmmh
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model

    devices = jax.devices("cpu")
    assert len(devices) >= max(widths), (
        f"need {max(widths)} virtual devices, have {len(devices)}"
    )
    model = sir_model()
    obs = get_observation_model("binomial")
    y = _dataset()

    def run(width, key):
        mesh = make_mesh(
            n_chain_shards=width, n_particle_shards=1,
            devices=devices[:width],
        )
        res = sharded_pmmh(
            mesh, model, obs, key, y, jnp.array([2.0, 1.0]), 0.05,
            n_chains_total=width * chains_per_shard,
            n_iters=n_iters, n_particles=n_particles,
            steps_per_unit=steps_per_unit,
            adaptive=True, adapt_start=8, pooled_adaptation=True,
            n_init_attempts=2, store_trajectories=store_trajectories,
        )
        np.asarray(res.thetas)  # block
        return res

    rows = []
    for width in widths:
        run(width, jax.random.PRNGKey(0))  # compile warmup
        walls, cpus = [], []
        for r in range(repeats):
            w0, c0 = time.perf_counter(), _cpu_seconds()
            run(width, jax.random.PRNGKey(r + 1))
            walls.append(time.perf_counter() - w0)
            cpus.append(_cpu_seconds() - c0)
        rows.append({
            "width": width,
            "chains_total": width * chains_per_shard,
            # min over repeats: the least-noise estimate of the true cost
            "wall_s": float(np.min(walls)),
            "cpu_s": float(np.median(cpus)),
        })
        print(f"[scaling] width={width} wall={rows[-1]['wall_s']:.3f}s "
              f"cpu={rows[-1]['cpu_s']:.3f}s", flush=True)

    base = rows[0]
    for row in rows:
        w = row["width"]
        # weak-scaling efficiency: per-shard work is constant, so ideal is
        # flat wall time; this is the BASELINE.md >= 0.8 claim
        row["eff_wall"] = round(base["wall_s"] / row["wall_s"], 4)
        # per-chain CPU-seconds relative to width 1 (< 1 means sharding made
        # each chain cheaper — per-op overhead amortizing across shards;
        # > 1 would mean collectives add per-chain work)
        row["cpu_per_chain_vs_w1"] = round(
            (row["cpu_s"] / row["chains_total"])
            / (base["cpu_s"] / base["chains_total"]),
            4,
        )
    return {
        "mode": mode,
        "backend": "cpu_virtual_mesh",
        "host_cpus": os.cpu_count(),
        "chains_per_shard": chains_per_shard,
        "n_iters": n_iters,
        "n_particles": n_particles,
        "note": (
            "wall-clock weak scaling on a host with few cores measures "
            "CORE OVERSUBSCRIPTION, not sharding quality: W virtual "
            "devices time-slice host_cpus cores, so once shards carry "
            "real compute eff_wall falls ~host_cpus/W. The single-host "
            "evidence for the >=80% claim is cpu_per_chain_vs_w1 <= 1: "
            "shard_map + collectives add no per-chain work (chains are "
            "independent; pooled adaptation exchanges only a [d,d] psum "
            "per iteration), so multi-device scaling is bounded by "
            "per-device throughput plus collective cost "
            "(particle_weak_scaling)."
        ),
        "rows": rows,
    }


def particle_weak_scaling(widths=WIDTHS, particles_per_shard=256,
                          steps_per_unit=10, repeats=3, reps_per_run=8):
    """Weak-scale sharded_particle_filter over the PARTICLE mesh axis:
    W shards x fixed particles/shard, so the psum-logsumexp weight reduction
    and the all_gather resampling collectives carry a measured cost, not
    just a correctness test.  Same wall/cpu
    efficiency semantics as the chain-axis harness."""
    import jax
    import jax.numpy as jnp

    from epitpu.dist import make_mesh, sharded_particle_filter
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model

    devices = jax.devices("cpu")
    assert len(devices) >= max(widths)
    model = sir_model()
    obs = get_observation_model("binomial")
    y = _dataset()

    def run(width, key):
        mesh = make_mesh(
            n_chain_shards=1, n_particle_shards=width,
            devices=devices[:width],
        )
        lls = []
        for r in range(reps_per_run):
            res = sharded_particle_filter(
                mesh, model, obs, jax.random.fold_in(key, r), y,
                jnp.array([2.0, 1.0]), 0.1,
                n_particles_total=width * particles_per_shard,
                steps_per_unit=steps_per_unit,
            )
            lls.append(res.log_likelihood)
        np.asarray(jnp.stack(lls))  # block

    rows = []
    for width in widths:
        run(width, jax.random.PRNGKey(0))  # compile warmup
        walls, cpus = [], []
        for r in range(repeats):
            w0, c0 = time.perf_counter(), _cpu_seconds()
            run(width, jax.random.PRNGKey(r + 1))
            walls.append(time.perf_counter() - w0)
            cpus.append(_cpu_seconds() - c0)
        rows.append({
            "width": width,
            "particles_total": width * particles_per_shard,
            "wall_s": float(np.min(walls)),
            "cpu_s": float(np.median(cpus)),
        })
        print(f"[scaling] particle width={width} "
              f"wall={rows[-1]['wall_s']:.3f}s cpu={rows[-1]['cpu_s']:.3f}s",
              flush=True)

    base = rows[0]
    for row in rows:
        row["eff_wall"] = round(base["wall_s"] / row["wall_s"], 4)
        row["cpu_per_particle_vs_w1"] = round(
            (row["cpu_s"] / row["particles_total"])
            / (base["cpu_s"] / base["particles_total"]),
            4,
        )
    return {
        "mode": "weak_scaling_particle_axis",
        "backend": "cpu_virtual_mesh",
        "host_cpus": os.cpu_count(),
        "particles_per_shard": particles_per_shard,
        "filter_reps_per_run": reps_per_run,
        "note": (
            "sharded_particle_filter at constant particles/shard: ideal "
            "eff_wall 1.0; collectives cost = psum-logsumexp weight "
            "normalization + all_gather of (logw, states) for global "
            "resampling each filter step. Virtual CPU devices time-slice "
            "past host_cpus, so eff_wall lower-bounds real devices; "
            "cpu_per_particle_vs_w1 <= 1 means collectives add no "
            "per-particle work."
        ),
        "rows": rows,
    }


def chip_chain_sweep(chain_counts=(8, 16, 32, 64, 128), n_iters=48,
                     n_particles=4096, steps_per_unit=20):
    """On-card throughput vs vmapped chain count (finds the chains/card
    sweet spot behind bench.py's headline number)."""
    import jax
    import jax.numpy as jnp

    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model

    model = sir_model()
    obs = get_observation_model("binomial")
    y = _dataset()

    def run(n_chains, key):
        # production bench configuration (rbg sampler + the
        # resample_every=4 schedule, matching bench.py's headline)
        r = particle_mcmc_chains(
            model, obs, key, y, jnp.array([2.0, 1.0]), 0.05,
            n_chains=n_chains, n_iters=n_iters, obs_param=0.1,
            n_particles=n_particles, n_population=4820, mu=20.0,
            steps_per_unit=steps_per_unit, n_init_attempts=2,
            sampler="fast_rbg", resample_every=4,
        )
        np.asarray(r.thetas)

    rows = []
    for n_chains in chain_counts:
        run(n_chains, jax.random.PRNGKey(0))  # compile
        t0 = time.perf_counter()
        run(n_chains, jax.random.PRNGKey(1))
        dt = time.perf_counter() - t0
        rows.append({
            "chains": n_chains,
            "wall_s": round(dt, 4),
            "iters_per_s": round(n_chains * n_iters / dt, 2),
        })
        print(f"[scaling] chains={n_chains} {rows[-1]['iters_per_s']:.1f} "
              f"iters/s", flush=True)
    return {
        "mode": "chip_chain_vmap_sweep",
        "device": _gpu_info(),
        "n_iters": n_iters,
        "n_particles": n_particles,
        "rows": rows,
    }


def large_regime(n_chains=32, n_particles=1024, n_iters=24,
                 steps_per_unit=20):
    """The reference-impossible workload on one card: population 10^6,
    T=100 daily Gaussian observations, full PMMH.  The reference's exact SSA is O(events) ~ O(population) Python
    iterations per particle-unit (reference gillespie_algo.py:48-73);
    BASELINE.md measures ~5 s per 100-particle T=15 filter call at
    population 4,820, i.e. ~3.3 ms per particle-step.  Events scale
    linearly with population, so at 10^6 one particle-step extrapolates to
    ~0.69 s, one 100-particle x T=100 filter call to ~1.9 HOURS, and a
    single 6,000-iteration chain to ~1.3 YEARS.  The tau-leap kernel's
    cost is population-independent; this measures the actual card rate.
    Numerical validity at this scale is pinned by
    tests/test_large_regime.py (float32 integer exactness < 2^24,
    binomial log-pmf vs float64 oracle)."""
    import jax
    import jax.numpy as jnp

    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model
    from epitpu.ode import sir_rhs, solve_on_integer_grid

    pop = 1_000_000.0
    theta = (0.3, 0.1)
    t = np.linspace(0, 99, 600)
    _, latent = solve_on_integer_grid(
        sir_rhs, (pop - 1000.0, 1000.0, 0.0), theta, t)
    rng = np.random.default_rng(23)
    y = jnp.asarray(
        rng.normal(latent, 0.05 * latent + 1e-4).astype(np.float32)
    )

    def run(key):
        r = particle_mcmc_chains(
            sir_model(), get_observation_model("gaussian"), key, y,
            jnp.asarray(theta, jnp.float32), 0.0005,
            n_chains=n_chains, n_iters=n_iters, obs_param=0.05,
            n_particles=n_particles, n_population=pop, mu=1000.0,
            steps_per_unit=steps_per_unit, n_init_attempts=2,
            sampler="fast_rbg", resample_every=4,
            store_trajectories=False,
        )
        return np.asarray(r.thetas)

    run(jax.random.PRNGKey(0))  # compile
    t0 = time.perf_counter()
    th = run(jax.random.PRNGKey(1))
    dt = time.perf_counter() - t0
    iters_per_s = n_chains * n_iters / dt
    # posterior sanity at the truth
    mean = th[:, n_iters // 3 :, :].reshape(-1, 2).mean(axis=0)
    ref_pf_call_s = 5.34 / (100 * 15) * (1_000_000 / 4820) * 100 * 100
    out = {
        "mode": "large_regime",
        "device": _gpu_info(),
        "population": pop,
        "t_obs": 100,
        "observation": "gaussian 0.05",
        "chains": n_chains,
        "particles": n_particles,
        "iters": n_iters,
        "wall_s": round(dt, 3),
        "iters_per_s": round(iters_per_s, 2),
        "posterior_mean": [round(float(v), 4) for v in mean],
        "theta_true": list(theta),
        "reference_extrapolation": {
            "basis": "BASELINE.md ~5.34 s / (100 particles x 15 steps) at "
                     "population 4,820; events scale O(population) "
                     "(reference gillespie_algo.py:48-73)",
            "ref_seconds_per_pf_call_100p_T100": round(ref_pf_call_s, 0),
            "ref_seconds_per_pmmh_iter": round(ref_pf_call_s, 0),
            "speedup_vs_reference_per_iteration": round(
                ref_pf_call_s * iters_per_s, 0
            ),
        },
    }
    print(f"[scaling] large_regime: {iters_per_s:.1f} iters/s "
          f"(pop 1e6, T=100, {n_chains}x{n_particles}); reference "
          f"extrapolates to {ref_pf_call_s/3600:.1f} h per iteration",
          flush=True)
    return out


def resampler_crossover(ns=(4096, 8192, 16384, 32768), chains=32,
                        reps=64):
    """Where does the O(N^2) compare-reduce systematic resampler cross over
    vs the O(N) counts+scatter variant?  ``SCATTER_THRESHOLD_N`` in
    epitpu/smc/resample.py is set from this sweep.

    Measured END-TO-END through the real filter: the resample output feeds
    the propagation which feeds the consumed log-likelihood, so XLA cannot
    dead-code-eliminate any of it (two earlier synthetic micro-bench
    designs measured pure dispatch because the optimizer hoisted or pruned
    the resample — the per-call numbers came out 1000x too small against
    the in-situ trace).  ``steps_per_unit=2`` keeps propagation small so
    the between-kind DELTA is dominated by the resampler; ``reps`` filters
    per jitted scan amortize the per-call dispatch.  The crossover N is
    where the scatter variant's end-to-end filter first wins."""
    import jax

    def make_bench(kind, n, y, model, obs):
        import jax.numpy as jnp

        from epitpu.smc import particle_filter

        @jax.jit
        def bench(key):
            def one(k):
                return particle_filter(
                    model, obs, k, y, jnp.array([2.0, 1.0]), 0.1,
                    n_particles=n, n_population=4820.0, mu=20.0,
                    steps_per_unit=2, resampling=kind, sampler="fast_rbg",
                ).log_likelihood

            def body(carry, k):
                ll = jnp.sum(jax.vmap(one)(jax.random.split(k, chains)))
                return carry + ll * 1e-12, None

            out, _ = jax.lax.scan(
                body, jnp.asarray(0.0), jax.random.split(key, reps)
            )
            return out

        return bench

    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model

    model = sir_model()
    obs = get_observation_model("binomial")
    y = _dataset()
    t_steps = int(np.asarray(y).shape[0]) - 1

    def timed(kind, n):
        bench = make_bench(kind, n, y, model, obs)
        jax.block_until_ready(bench(jax.random.PRNGKey(0)))  # compile
        best = float("inf")
        for seed in (1, 2, 3):
            t0 = time.perf_counter()
            jax.block_until_ready(bench(jax.random.PRNGKey(seed)))
            best = min(best, time.perf_counter() - t0)
        # per chains-batched RESAMPLE step (T-1 resamples per filter)
        return 1e6 * best / (reps * t_steps)

    rows = []
    for n in ns:
        row = {"n_particles": n, "chains": chains}
        for kind in ("systematic", "systematic_scatter"):
            row[kind + "_us_per_step"] = round(timed(kind, n), 2)
        row["scatter_speedup_e2e"] = round(
            row["systematic_us_per_step"]
            / row["systematic_scatter_us_per_step"], 3
        )
        rows.append(row)
        print(f"[scaling] resampler N={n}: filter-step compare-reduce "
              f"{row['systematic_us_per_step']}us vs scatter "
              f"{row['systematic_scatter_us_per_step']}us "
              f"(scatter {row['scatter_speedup_e2e']}x)", flush=True)
    crossover = next(
        (r["n_particles"] for r in rows if r["scatter_speedup_e2e"] > 1.0),
        None,
    )
    return {
        "mode": "resampler_crossover",
        "device": _gpu_info(),
        "chains": chains,
        "reps": reps,
        "rows": rows,
        "crossover_n": crossover,
        "note": (
            "End-to-end filter-step time (32 vmapped chains, T=15, "
            "steps_per_unit=2 so the between-kind delta is resampler-"
            "dominated), reps filters per jitted scan, best-of-3. "
            "Synthetic micro-benches were abandoned: XLA pruned/hoisted "
            "the resample and measured pure dispatch. The compare-reduce "
            "is O(N^2) compares; scatter is O(N) but "
            "scatter/gather-bound. crossover_n = smallest N where the "
            "scatter variant's end-to-end filter wins (null = never in "
            "the sweep)."
        ),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--chip", action="store_true",
                    help="on-card chain-count sweep (GPU)")
    ap.add_argument("--particle", action="store_true",
                    help="particle-axis weak scaling (virtual CPU mesh)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="chain-axis weak scaling at the production preset "
                    "shape (16 chains/shard x 16 particles, theta-only "
                    "fast path; virtual CPU mesh)")
    ap.add_argument("--resampler", action="store_true",
                    help="compare-reduce vs scatter resampler N-sweep (GPU)")
    ap.add_argument("--large-regime", action="store_true",
                    help="population-10^6 / T=100 PMMH bench with the "
                    "reference-SSA extrapolation (GPU)")
    ap.add_argument("--out", default="SCALING.json")
    args = ap.parse_args(argv)

    gpu_mode = args.chip or args.resampler or args.large_regime
    if not gpu_mode:
        # the CPU modes run on 8 virtual CPU devices; set before jax starts
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    import epitpu

    epitpu.enable_compilation_cache()
    if gpu_mode:
        _gpu_info()  # refuse to measure anything but a GPU

    existing = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)

    if args.large_regime:
        existing["large_regime"] = large_regime()
    elif args.resampler:
        existing["resampler_crossover"] = resampler_crossover()
    elif args.chip:
        existing["chip_chain_sweep"] = chip_chain_sweep()
    elif args.particle:
        existing["particle_weak_scaling"] = particle_weak_scaling()
    elif args.production_mesh:
        # the production preset shape scaled over the chain mesh axis:
        # same harness and note, per-shard slice of the 2048x16
        # configuration (16 chains/shard keeps a small host inside the
        # CPU-seconds criterion's noise floor)
        existing["weak_scaling_production_shape"] = weak_scaling(
            chains_per_shard=16, n_particles=16, steps_per_unit=10,
            store_trajectories=False, mode="weak_scaling_production_shape",
        )
    else:
        existing["weak_scaling"] = weak_scaling()

    with open(args.out, "w") as f:
        json.dump(existing, f, indent=2)
    print(json.dumps(existing, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
