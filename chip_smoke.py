"""Smoke test of the PMMH main path on one GPU, through the user entry points.

    python chip_smoke.py [--out DIR]     # phases 0-5 on one GPU
    python chip_smoke.py --multi         # only the sharded path, on 4 GPUs

Phases, in order; each prints one line naming the card:

0. device: the default backend must be a GPU (there is no CPU fallback);
   prints the device kind and count, the JAX version and the card's name
   and power limit as nvidia-smi reports them.
1. exact-integer tau-leap: population 10^6, 32 chains x 1,024 particles,
   ``advance`` over several units.  Every state is integral, each
   particle's population is conserved exactly, and a substep's state update
   equals a float64 numpy recomputation from the same event counts.
2. sampler law: the ``fast`` and ``fast_rbg`` binomials against
   ``scipy.stats.binom`` moments over n x p, 2^20 draws per point.
3. filter against the plain reference: flagship particle filter over 64
   keys on the GPU and on the host CPU, means within 4 combined standard
   errors; compare-reduce vs scatter resampler ancestors on identical
   weights and uniforms.
4. PMMH through the CLI: ``run_experiment`` of the ``production`` preset
   (2,048 chains x 2,000 iterations) with its convergence gates, then the
   bench's 32 chains x 4,096 particles for 128 iterations.
5. ABC and forecast presets through ``run_experiment``, and their warm
   throughput (candidates/s, forecast draws/s).

``--multi`` runs only ``sharded_pmmh`` (2,048 chains over 4 chain shards,
and 32 x 4,096 on a 2 x 2 chain x particle mesh) and the particle-sharded
filter against a single-card run.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
it is printed only when every phase passed.  Compile and run times are
printed as information, not as a benchmark.  Artifacts go under ``--out``.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

FLAGSHIP_THETA = (2.0, 1.0)
# phase 3: largest distance, as a fraction of the total weight, between a
# resampling point and the cdf boundaries it falls between when the two
# resamplers disagree (float32 cumsum rounding at N=4,096)
TIE_TOL = 1e-5


class SmokeFailure(AssertionError):
    """A phase's check did not hold."""


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


class CompileClock:
    """Sums JAX's compile-phase durations (tracing, lowering, backend
    compile) reported through ``jax.monitoring``, so a phase can split its
    wall time into compile and run."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if name.startswith("/jax/core/compile/"):
            self.seconds += secs

    def timed(self, fn):
        """Run ``fn()``; return (result, wall seconds, compile seconds)."""
        c0, t0 = self.seconds, time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, self.seconds - c0


def _say(phase, kind, msg):
    print(f"[{phase}] {kind}: {msg}", flush=True)


def _flagship_y():
    from epitpu.cli.configs import ExperimentConfig
    from epitpu.cli.run import generate_dataset

    y, _ = generate_dataset(ExperimentConfig())
    return y


def _dot_generals(jaxpr):
    """Every dot_general equation in a jaxpr, sub-jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found.extend(_dot_generals(inner))
    return found


def gpu_name_and_power_limit():
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_device():
    """Phase 0: the default backend must be a GPU.  Returns its device."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeFailure(
            f"default JAX backend is {dev.platform!r}, not a GPU"
        )
    _say("device", dev.device_kind,
         f"platform={dev.platform} count={len(jax.devices())} "
         f"jax={jax.__version__}")
    print(gpu_name_and_power_limit(), flush=True)  # "name, power.limit"
    return dev


def phase_tauleap(device, pop=1_000_000, n_chains=32, n_particles=1024,
                  units=8, steps_per_unit=20, sampler="fast_rbg"):
    """Phase 1: the tau-leap state stays exact float32 integers at
    population ``pop``, and the substep update is bit-exact."""
    import jax
    import jax.numpy as jnp

    from epitpu.models import sir_model
    from epitpu.sim import advance, event_counts, substep

    model = sir_model()
    theta = jnp.asarray(FLAGSHIP_THETA, jnp.float32)
    dt = 1.0 / steps_per_unit
    i0 = 1000.0
    x = jax.device_put(jnp.broadcast_to(
        jnp.asarray([pop - i0, i0, 0.0], jnp.float32),
        (n_chains, n_particles, 3),
    ), device)
    key = jax.device_put(jax.random.PRNGKey(11), device)
    counts_fn = jax.jit(
        lambda k, x: event_counts(model, k, x, theta, dt, sampler))
    step_fn = jax.jit(lambda k, x: substep(model, k, x, theta, dt, sampler))
    n_dots = len(_dot_generals(jax.make_jaxpr(
        lambda k, x: advance(model, k, x, theta, 1.0, steps_per_unit,
                             sampler))(key, x).jaxpr))
    _check(n_dots == 0, f"advance lowers {n_dots} dot_general(s)")
    stoich = model.stoich.astype(np.float64)
    # information only: what a default-precision float32 dot makes of the
    # same update (the form the state update no longer takes)
    default_dot = jax.jit(lambda n: n @ jnp.asarray(stoich, jnp.float32))
    max_count, dot_errors = 0.0, 0
    for _ in range(units):
        key, k_sub, k_adv = jax.random.split(key, 3)
        n_ev_dev = counts_fn(k_sub, x)
        n_ev = np.asarray(n_ev_dev, np.float64)
        x_next = np.asarray(step_fn(k_sub, x))
        want = np.asarray(x, np.float64) + n_ev @ stoich
        _check(np.array_equal(x_next.astype(np.float64), want),
               "substep update differs from the float64 recomputation")
        dot_errors += int(np.sum(
            np.asarray(default_dot(n_ev_dev), np.float64) != n_ev @ stoich))
        max_count = max(max_count, float(n_ev.max()))
        x = advance(model, k_adv, x, theta, 1.0, steps_per_unit, sampler)
        a = np.asarray(x)
        _check(a.dtype == np.float32, f"state dtype {a.dtype}")
        _check(np.array_equal(a, np.round(a)), "non-integral state")
        _check(a.min() >= 0, "negative compartment")
        _check(np.all(a.astype(np.float64).sum(-1) == pop),
               "population not conserved")
    _say("tauleap", device.device_kind,
         f"ok: pop={pop:g} {n_chains}x{n_particles} particles, {units} units"
         f" x {steps_per_unit} substeps, sampler={sampler}, float32 state, "
         f"no dot_general on the path; largest substep event count "
         f"{max_count:g}, final I mean {a[..., 1].mean():.1f}; a "
         f"default-precision dot of the same updates got {dot_errors} "
         f"entries wrong")
    return {"max_event_count": max_count, "default_dot_errors": dot_errors}


def phase_sampler_law(device, n_draws=1 << 20, ns=(20, 4820, 1_000_000),
                      ps=(1e-3, 0.05, 0.3), samplers=("fast", "fast_rbg")):
    """Phase 2: each sampler's Binomial(n, p) moments against scipy: the
    mean within 4 standard errors, the variance within 10%."""
    import jax
    import jax.numpy as jnp
    from scipy.stats import binom

    from epitpu.sim import draw_binomial

    grid = [(n, p) for n in ns for p in ps]
    n_col = jnp.asarray([[n] for n, _ in grid], jnp.float32)
    p_col = jnp.asarray([[p] for _, p in grid], jnp.float32)
    n_full = jax.device_put(
        jnp.broadcast_to(n_col, (len(grid), n_draws)), device)
    p_full = jax.device_put(
        jnp.broadcast_to(p_col, (len(grid), n_draws)), device)
    worst = 0.0
    for i, sampler in enumerate(samplers):
        key = jax.device_put(jax.random.PRNGKey(100 + i), device)
        draws = jax.jit(
            lambda k, n, p: draw_binomial(k, n, p, sampler))(
                key, n_full, p_full)
        d = np.asarray(draws, np.float64)
        for row, (n, p) in enumerate(grid):
            mean_t, var_t = (float(v) for v in binom.stats(n, p))
            se = np.sqrt(var_t / n_draws)
            z = (d[row].mean() - mean_t) / se
            rel_var = d[row].var() / var_t - 1.0
            _check(abs(z) < 4.0,
                   f"{sampler} n={n} p={p}: mean off by {z:.2f} se")
            _check(abs(rel_var) < 0.10,
                   f"{sampler} n={n} p={p}: variance off by {rel_var:+.3f}")
            worst = max(worst, abs(z))
    _say("sampler_law", device.device_kind,
         f"ok: {'/'.join(samplers)} over {len(grid)} (n, p) points, "
         f"{n_draws} draws each; worst mean offset {worst:.2f} se")
    return {"worst_mean_z": worst}


def _filter_lls(device, y, seeds, n_particles, steps_per_unit):
    import jax
    import jax.numpy as jnp

    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model
    from epitpu.smc import particle_filter

    model, obs = sir_model(), get_observation_model("binomial")

    def one(k, y, theta):
        return particle_filter(
            model, obs, k, y, theta, 0.1, n_particles=n_particles,
            n_population=4820.0, mu=20.0, steps_per_unit=steps_per_unit,
        ).log_likelihood

    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    args = jax.device_put(
        (keys, jnp.asarray(y), jnp.asarray(FLAGSHIP_THETA, jnp.float32)),
        device)
    return np.asarray(
        jax.jit(jax.vmap(one, in_axes=(0, None, None)))(*args), np.float64)


def phase_filter_vs_cpu(device, cpu, n_particles=4096, n_keys=64,
                        steps_per_unit=20, resample_n=4096, resample_rows=32):
    """Phase 3: the flagship filter's log-likelihood on ``device`` agrees
    with the same keys on ``cpu`` within 4 combined standard errors; the
    compare-reduce and scatter resamplers give the same ancestors."""
    import jax

    from epitpu.smc.resample import (
        SCATTER_THRESHOLD_N,
        systematic_resample,
        systematic_resample_scatter,
    )

    y = _flagship_y()
    seeds = np.arange(n_keys)
    ll_dev = _filter_lls(device, y, seeds, n_particles, steps_per_unit)
    ll_cpu = _filter_lls(cpu, y, seeds, n_particles, steps_per_unit)
    _check(np.isfinite(ll_dev).all() and np.isfinite(ll_cpu).all(),
           "non-finite log-likelihood")
    se = np.sqrt(ll_dev.var(ddof=1) / n_keys + ll_cpu.var(ddof=1) / n_keys)
    gap = ll_dev.mean() - ll_cpu.mean()
    _check(abs(gap) < 4.0 * se,
           f"logZ mean {ll_dev.mean():.3f} vs cpu {ll_cpu.mean():.3f}, "
           f"gap {gap:.3f} > 4 se = {4 * se:.3f}")

    # resamplers on identical weights and uniforms: both draw their one
    # uniform per row from the same key
    _check(resample_n < SCATTER_THRESHOLD_N,
           "compare-reduce must be the systematic default at resample_n")
    rng = np.random.default_rng(7)
    logw = jax.device_put(
        (3.0 * rng.standard_normal((resample_rows, resample_n)))
        .astype(np.float32), device)
    key = jax.device_put(jax.random.PRNGKey(5), device)
    a_cr, _ = jax.jit(systematic_resample)(key, logw)
    a_sc, _ = jax.jit(systematic_resample_scatter)(key, logw)
    a_cr, a_sc = np.asarray(a_cr), np.asarray(a_sc)
    n_diff = int((a_cr != a_sc).sum())
    # a mismatch is allowed only at a CDF boundary tie: every cdf boundary
    # between the two ancestors lies within TIE_TOL of the total from the
    # point (each kernel rounds its own float32 cumsum and comparison)
    tie_gap = 0.0
    if n_diff:
        lw = np.asarray(logw, np.float64)
        w = np.exp(lw - lw.max(-1, keepdims=True))
        cdf = np.cumsum(w, -1) / w.sum(-1, keepdims=True)
        u = np.asarray(jax.random.uniform(key, (resample_rows, 1)),
                       np.float64)
        pts = (np.arange(resample_n) + u) / resample_n
        for r, c in zip(*np.nonzero(a_cr != a_sc)):
            lo, hi = sorted((int(a_cr[r, c]), int(a_sc[r, c])))
            tie_gap = max(tie_gap, float(np.abs(cdf[r, lo:hi] - pts[r, c])
                                         .max()))
    _say("filter_vs_cpu", device.device_kind,
         f"logZ mean {ll_dev.mean():.4f} (sd {ll_dev.std(ddof=1):.4f}) "
         f"vs cpu {ll_cpu.mean():.4f} (sd {ll_cpu.std(ddof=1):.4f}), "
         f"gap {gap:+.4f}, 4 se {4 * se:.4f}, {n_keys} keys x {n_particles}"
         f" particles; resamplers at N={resample_n}: {n_diff} of "
         f"{a_cr.size} ancestors differ, largest boundary gap "
         f"{tie_gap:.2e} of the total (tie tolerance {TIE_TOL:g})")
    _check(tie_gap < TIE_TOL,
           f"{n_diff} ancestor mismatches, not all at boundary ties")
    return {"ll_gap": gap, "ll_se": se, "resample_mismatches": n_diff}


def phase_pmmh(device, out_dir, clock, cfg=None,
               bench_shape=(32, 4096, 128)):
    """Phase 4: the ``production`` preset through ``run_experiment``
    (``cfg`` overrides it for a rehearsal) with its convergence gates, then
    the bench shape (chains, particles, iterations)."""
    import jax
    import jax.numpy as jnp

    from epitpu.cli.run import PRESETS, run_experiment
    from epitpu.diag import pool_chains
    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model

    cfg = cfg or PRESETS["production"]()
    cfg.make_plots = False
    cfg.out_dir = os.path.join(out_dir, "data")
    cfg.graphs_dir = os.path.join(out_dir, "graphs")
    m = cfg.mcmc
    with jax.default_device(device):
        (result, report), wall, comp = clock.timed(
            lambda: run_experiment(cfg, verbose=False))
    th = np.asarray(result.thetas)
    _check(np.isfinite(th).all(), "non-finite thetas")
    rhat = max(report["gelman_rubin_rank"])
    acc = float(np.mean(report["acceptance"]))
    _check(rhat < 1.1, f"max rank-R-hat {rhat:.3f} >= 1.1")
    _check(0.05 < acc < 0.7, f"mean acceptance {acc:.3f} outside (0.05, 0.7)")
    pooled = pool_chains(th, burn_in=max(1, m.n_iters // 10))
    lo, hi = np.quantile(pooled, [0.05, 0.95], axis=0)
    truth = np.asarray(cfg.data.theta_true)
    _check(np.all((lo <= truth) & (truth <= hi)),
           f"90% interval [{lo}, {hi}] misses theta_true {truth}")
    _say("pmmh_production", device.device_kind,
         f"ok: {m.n_chains} chains x {m.n_iters} iters, N="
         f"{report['n_particles']} (self-sized), max rank-R-hat {rhat:.4f}, "
         f"min rank-ESS {min(report['ess_rank']):.1f}, acceptance "
         f"{acc:.3f}, 90% CI beta [{lo[0]:.3f}, {hi[0]:.3f}] gamma "
         f"[{lo[1]:.3f}, {hi[1]:.3f}]; wall {wall:.1f} s of which compile "
         f"{comp:.1f} s")

    n_chains, n_particles, n_iters = bench_shape
    y = jax.device_put(jnp.asarray(_flagship_y()), device)

    def bench_run(seed):
        r = particle_mcmc_chains(
            sir_model(), get_observation_model("binomial"),
            jax.device_put(jax.random.PRNGKey(seed), device), y,
            jax.device_put(jnp.asarray(FLAGSHIP_THETA), device), 0.05,
            n_chains=n_chains, n_iters=n_iters, obs_param=0.1,
            n_particles=n_particles, n_population=4820, mu=20.0,
            steps_per_unit=20, n_init_attempts=2, sampler="fast_rbg",
            resample_every=4,
        )
        return np.asarray(r.thetas), np.asarray(r.acceptances)

    _, wall1, comp1 = clock.timed(lambda: bench_run(0))
    (th_b, acc_b), wall2, _ = clock.timed(lambda: bench_run(1))
    _check(np.isfinite(th_b).all(), "bench shape: non-finite thetas")
    acc_b = float(acc_b.mean()) / n_iters
    _check(0.0 < acc_b < 1.0, f"bench shape: acceptance {acc_b:.3f}")
    _say("pmmh_bench_shape", device.device_kind,
         f"ok: {n_chains} chains x {n_particles} particles x {n_iters} "
         f"iters, acceptance {acc_b:.3f}; first call {wall1:.1f} s "
         f"(compile {comp1:.1f} s), warm call {wall2:.2f} s = "
         f"{n_chains * n_iters / wall2:.1f} iters/s")
    return {"rhat": rhat, "acceptance": acc}


def phase_batch_paths(device, out_dir, clock, abc_cfg=None, fc_cfg=None,
                      abc_batch=4096, abc_trials=1 << 20, fc_draws=1 << 16):
    """Phase 5: the ABC and forecast presets through ``run_experiment``,
    then the warm throughput of each batch path on XLA."""
    import jax
    import jax.numpy as jnp

    from epitpu.abc import abc_rejection
    from epitpu.cli.run import PRESETS, generate_dataset, run_experiment
    from epitpu.mcmc import posterior_forecast
    from epitpu.models import sir_model

    abc_cfg = abc_cfg or PRESETS["sir_abc"]()
    fc_cfg = fc_cfg or PRESETS["sir_underreported"]()
    fc_cfg.forecast_horizon = fc_cfg.forecast_horizon or 5
    for cfg in (abc_cfg, fc_cfg):
        cfg.make_plots = False
        cfg.out_dir = os.path.join(out_dir, "data")
        cfg.graphs_dir = os.path.join(out_dir, "graphs")
    with jax.default_device(device):
        abc_res, abc_rep = run_experiment(abc_cfg, verbose=False)
        _check(abc_rep["acceptance"] > 0, "ABC accepted nothing")
        _check(np.isfinite(abc_res.trajectories).all(),
               "ABC: non-finite trajectories")
        _, fc_rep = run_experiment(fc_cfg, verbose=False)
        fc = np.load(os.path.join(fc_cfg.out_dir, fc_cfg.name,
                                  "forecast.npy"))
        _check(np.isfinite(fc).all() and fc.shape[1:] == (
            fc_cfg.forecast_horizon + 1, 3), f"forecast shape {fc.shape}")

        # warm ABC throughput at a production batch, to a fixed trial count
        model = sir_model()
        y, _ = generate_dataset(abc_cfg)
        priors = {n: (abc_cfg.abc.prior_lo, abc_cfg.abc.prior_hi)
                  for n in model.theta_names}

        def abc(seed, trials):
            return abc_rejection(
                model, jax.random.PRNGKey(seed), y, n_samples=trials,
                threshold=abc_cfg.abc.threshold, priors=priors,
                batch_size=abc_batch, max_trials=trials)

        abc(0, 4 * abc_batch)  # compile
        res, abc_wall, _ = clock.timed(lambda: abc(1, abc_trials))
        cand_per_s = res.trials / abc_wall

        thetas = jnp.broadcast_to(
            jnp.asarray(FLAGSHIP_THETA, jnp.float32), (fc_draws, 2))
        states = jnp.broadcast_to(
            jnp.asarray(fc[0, 0], jnp.float32), (fc_draws, 3))

        def forecast(seed):
            return np.asarray(posterior_forecast(
                model, jax.random.PRNGKey(seed), thetas, states,
                fc_cfg.forecast_horizon))

        forecast(0)
        out, fc_wall, _ = clock.timed(lambda: forecast(1))
        _check(np.isfinite(out).all(), "forecast: non-finite draws")
    _say("batch_paths", device.device_kind,
         f"ok: sir_abc acceptance {abc_rep['acceptance']:.4f}, forecast "
         f"{fc.shape[0]} draws x {fc_cfg.forecast_horizon} days; warm ABC "
         f"{res.trials} candidates (batch {abc_batch}) in {abc_wall:.3f} s "
         f"= {cand_per_s:.0f} candidates/s; warm forecast {fc_draws} draws "
         f"x {fc_cfg.forecast_horizon} days in {fc_wall:.3f} s = "
         f"{fc_draws / fc_wall:.0f} draws/s")
    return {"candidates_per_s": cand_per_s,
            "forecast_draws_per_s": fc_draws / fc_wall}


def phase_multi(devices, n_devices=4, pmmh_iters=200, prod_chains=2048,
                mesh_particles=4096, filter_seeds=16):
    """``--multi``: ``sharded_pmmh`` at the production shape (2,048 chains
    x 16 particles) over 4 chain shards and at 32 chains x 4,096 particles
    on a 2 x 2 mesh, with the replication invariant, and the
    particle-sharded filter against one card."""
    from __graft_entry__ import check_sharded_filter, check_sharded_pmmh

    _check(len(devices) >= n_devices,
           f"--multi needs {n_devices} devices, found {len(devices)}")
    devs = devices[:n_devices]
    kind = devs[0].device_kind
    t0 = time.perf_counter()
    th = check_sharded_pmmh(
        devs, 1, n_chains_total=prod_chains, n_iters=pmmh_iters, h=0.6,
        check_pooled_effect=False, n_particles=16, steps_per_unit=20,
        adapt_start=16, resample_every=4, sampler="fast_rbg",
        store_trajectories=False,
    )
    mean = th[:, pmmh_iters // 5:].reshape(-1, 2).mean(0)
    _check(np.all(np.abs(mean - np.asarray(FLAGSHIP_THETA)) < 0.5),
           f"production-shape posterior mean {mean} far from the truth")
    _say("multi_pmmh_production", kind,
         f"ok: {prod_chains} chains x {pmmh_iters} iters x 16 particles over "
         f"{n_devices} chain shards, posterior mean {mean.round(3)}; "
         f"{time.perf_counter() - t0:.1f} s with compile")
    t0 = time.perf_counter()
    check_sharded_pmmh(
        devs, 2, n_chains_total=32, n_iters=32, n_particles=mesh_particles,
        steps_per_unit=20, resample_every=4, sampler="fast_rbg",
    )
    _say("multi_pmmh_2x2", kind,
         f"ok: 32 chains x {mesh_particles} particles on a 2 chain x 2 "
         f"particle mesh, "
         f"particle shards bit-identical, pooling effective; "
         f"{time.perf_counter() - t0:.1f} s with compile")
    sharded, single = check_sharded_filter(
        devs, mesh_particles, 20, seeds=range(filter_seeds))
    se = np.sqrt(sharded.var(ddof=1) / len(sharded)
                 + single.var(ddof=1) / len(single))
    gap = sharded.mean() - single.mean()
    _check(abs(gap) < 4.0 * se,
           f"sharded logZ {sharded.mean():.3f} vs one card "
           f"{single.mean():.3f}: gap {gap:.3f} > 4 se {4 * se:.3f}")
    _say("multi_filter", kind,
         f"ok: {n_devices * mesh_particles} particles sharded over "
         f"{n_devices} cards, "
         f"logZ mean {sharded.mean():.4f} vs one card {single.mean():.4f}, "
         f"gap {gap:+.4f}, 4 se {4 * se:.4f}, {filter_seeds} seeds")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the phases' artifacts")
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path on 4 GPUs")
    args = ap.parse_args(argv)

    # phase 3 needs the host CPU beside the GPU; a platform list that
    # leaves it out gets it added before JAX starts
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"

    import epitpu

    epitpu.enable_compilation_cache()
    import jax

    try:
        dev = phase_device()
    except (SmokeFailure, OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    clock = CompileClock()
    if args.multi:
        phases = [("multi", lambda: phase_multi(jax.devices("gpu")))]
    else:
        cpu = jax.devices("cpu")[0]
        phases = [
            ("tauleap", lambda: phase_tauleap(dev)),
            ("sampler_law", lambda: phase_sampler_law(dev)),
            ("filter_vs_cpu", lambda: phase_filter_vs_cpu(dev, cpu)),
            ("pmmh", lambda: phase_pmmh(dev, args.out, clock)),
            ("batch_paths", lambda: phase_batch_paths(dev, args.out, clock)),
        ]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            _say(name, dev.device_kind, "FAILED")
            failed.append(name)
        print(f"[{name}] {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
