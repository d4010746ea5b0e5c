"""Config-driven experiment runner.

Replaces the reference's per-script workflow (generate data -> run PMCMC ->
save CSVs -> plot -> print diagnostics, repeated across ~20 scripts) with one
entry point:

    python -m epitpu.cli.run --preset sir_underreported
    python -m epitpu.cli.run --config my_experiment.json
    python -m epitpu.cli.run --sweep noise

Artifacts land in the reference's layout: ``<out_dir>/<name>/run<i>/*.csv``
and ``<graphs_dir>/<name>/run<i>/*.png``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .configs import (
    ABCConfig,
    DataConfig,
    ExperimentConfig,
    MCMCConfig,
    noise_sweep,
    pobs_sweep,
    tmps_sweep,
)


def build_model(cfg: ExperimentConfig):
    from ..models import seir_model, sir_model, sir_subgroups_model

    if cfg.model == "sir":
        return sir_model()
    if cfg.model == "seir":
        return seir_model()
    if cfg.model in ("sir_subgroups", "sir_subgroups2"):
        return sir_subgroups_model(
            k=cfg.subgroups,
            aggregated_obs=(cfg.model == "sir_subgroups2" or cfg.data.aggregate_obs),
        )
    raise ValueError(f"unknown model {cfg.model!r}")


def generate_dataset(cfg: ExperimentConfig):
    """ODE ground truth + observation thinning, like every reference driver
    (e.g. tests/test_pmcmc_noisy.py:20-29).  Returns (y, latent)."""
    from ..ode import (
        make_sir_subgroups_rhs,
        seir_rhs,
        sir_rhs,
        solve_on_integer_grid,
    )

    d = cfg.data
    t = np.linspace(0, d.t_max, d.grid_points)
    if cfg.model in ("sir", "seir"):
        rhs = sir_rhs if cfg.model == "sir" else seir_rhs
        _, latent = solve_on_integer_grid(rhs, tuple(d.y0), d.theta_true, t)
        latent_obs = latent
    else:
        k = cfg.subgroups
        y0 = np.asarray(d.y0, dtype=float).reshape(k, 3)
        theta = np.asarray(d.theta_true, dtype=np.float32)
        _, latent = solve_on_integer_grid(
            make_sir_subgroups_rhs(k), y0.reshape(-1), theta, t
        )
        if cfg.model == "sir_subgroups2":
            # aggregate observation over groups (reference pmcmc.py:172-175)
            latent_obs = sum(
                latent[:, 3 * g : 3 * (g + 1)] for g in range(k)
            )
        else:
            latent_obs = latent

    rng = np.random.default_rng(d.seed)
    if d.observation == "binomial":
        y = rng.binomial(np.round(latent_obs).astype(int), d.obs_param)
    elif d.observation == "gaussian":
        y = rng.normal(latent_obs, d.obs_param * latent_obs + 1e-4)
    else:
        y = latent_obs
    return y.astype(np.float32), latent


def run_abc(cfg: ExperimentConfig, verbose=True):
    """ABC rejection workload (reference tests/simulated_data.py:39-54,
    tests/test_abc_sir.py:43): uniform priors, accept below threshold, save
    the posterior dict as JSON + plot chains/KDE/trajectory CIs."""
    import json

    import jax

    from ..abc import abc_rejection
    from ..diag import summarize_chain
    from ..io import save_dataset

    model = build_model(cfg)
    y, latent = generate_dataset(cfg)
    out_root = os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(out_root, exist_ok=True)
    save_dataset(os.path.join(out_root, "dataset.csv"), y)

    a = cfg.abc
    priors = {
        name: (a.prior_lo, a.prior_hi) for name in model.theta_names
    }
    t0 = time.time()
    result = abc_rejection(
        model,
        jax.random.PRNGKey(cfg.seed),
        y,
        n_samples=a.n_samples,
        threshold=a.threshold,
        priors=priors,
        batch_size=a.batch_size,
        steps_per_unit=a.steps_per_unit,
    )
    elapsed = time.time() - t0

    # reference saves the posterior dict as JSON (tests/simulated_data.py:53)
    with open(os.path.join(out_root, "posterior.json"), "w") as f:
        json.dump({k: v.tolist() for k, v in result.posterior.items()}, f)
    thetas = np.stack(
        [result.posterior[n] for n in model.theta_names], axis=1
    )
    report = {
        "name": cfg.name,
        "algo": "abc",
        "samples": int(thetas.shape[0]),
        "trials": int(result.trials),
        "acceptance": result.acceptance_rate,
        "seconds": elapsed,
        "samples_per_s": thetas.shape[0] / elapsed,
        "summary": summarize_chain(thetas, list(model.theta_names)),
    }
    if cfg.make_plots:
        from ..viz import pair_plot, trace_plots, trajectory_fan

        gdir = os.path.join(cfg.graphs_dir, cfg.name, "run1")
        trace_plots(thetas, gdir, list(model.theta_names))
        pair_plot(thetas, gdir, list(model.theta_names))
        trajectory_fan(
            result.trajectories, gdir, observed=np.asarray(y),
            latent_truth=latent,
        )
    if verbose:
        print(json.dumps(report, indent=2, default=float))
    return result, report


def _run_pmmh_segmented(cfg, sampler_fn, model, obs, y, theta0, common,
                        out_root, verbose=True):
    """Drive PMMH in ``cfg.checkpoint_every``-iteration segments (one segment
    when checkpointing is off).  After each segment: save a resumable
    full-state checkpoint and print a live progress line (the many-chain
    equivalent of the reference's per-iteration tqdm stream,
    reference pmcmc.py:320-321).  Segment concatenation is bit-identical to
    the unsegmented run (see epitpu.mcmc.particle_mcmc); ``cfg.resume``
    continues from <out_root>/checkpoint.npz.
    """
    import dataclasses as _dc

    import jax

    m = cfg.mcmc
    seg = cfg.checkpoint_every if cfg.checkpoint_every > 0 else m.n_iters
    ckpt_path = os.path.join(out_root, "checkpoint.npz")
    master_key = jax.random.PRNGKey(cfg.seed)

    state = None
    hist = None  # (thetas [M, rows, d], lls [M, rows], trajs [M, rows, T, C])
    rows = 0
    if cfg.resume:
        from ..io import load_pmmh_checkpoint

        ck = load_pmmh_checkpoint(ckpt_path)
        if ck is not None:
            if ck.n_iters != m.n_iters:
                raise ValueError(
                    f"checkpoint was written for n_iters={ck.n_iters}, "
                    f"config asks for {m.n_iters}"
                )
            expect = np.asarray(jax.random.key_data(master_key))
            if not np.array_equal(ck.key_data, expect):
                raise ValueError(
                    "checkpoint master key does not match this config's seed"
                )
            state = ck.state
            hist = (ck.thetas, ck.log_likelihoods, ck.sampled_trajs)
            rows = int(np.asarray(ck.state.step).reshape(-1)[0]) + 1
            if verbose:
                print(
                    f"[pmmh] resuming {cfg.name} from checkpoint at "
                    f"iter {rows}/{m.n_iters}",
                    flush=True,
                )

    t_start = time.time()
    while rows < m.n_iters:
        seg_len = min(seg, m.n_iters - rows)
        result = sampler_fn(
            model, obs, master_key, y, theta0, m.h,
            init_state=state, segment_len=seg_len, **common,
        )
        new = (
            np.asarray(result.thetas),
            np.asarray(result.log_likelihoods),
            np.asarray(result.sampled_trajs),
        )
        hist = new if hist is None else tuple(
            np.concatenate([h, n], axis=1) for h, n in zip(hist, new)
        )
        state = result.final_state
        rows += seg_len
        if cfg.checkpoint_every > 0:
            from ..io import save_pmmh_checkpoint

            save_pmmh_checkpoint(
                ckpt_path, state, master_key, m.n_iters, *hist,
                meta={"name": cfg.name, "seed": cfg.seed},
            )
        if verbose and (cfg.checkpoint_every > 0 or rows < m.n_iters):
            acc = np.asarray(state.acceptances, dtype=float) / max(rows, 1)
            th = np.asarray(state.theta)
            print(
                f"[pmmh] {cfg.name}: iter {rows}/{m.n_iters}  "
                f"elapsed={time.time() - t_start:.1f}s  "
                f"acc_ratio={float(np.mean(acc)):.3f}  "
                f"theta_mean=[{', '.join(f'{v:.4g}' for v in th.mean(axis=0))}]  "
                f"log_zeta_mean={float(np.mean(np.asarray(state.log_likelihood))):.3f}",
                flush=True,
            )

    from ..mcmc import PMMHResult

    return PMMHResult(
        thetas=hist[0],
        log_likelihoods=hist[1],
        sampled_trajs=hist[2],
        acceptances=np.asarray(state.acceptances),
        final_state=state,
    )


def run_experiment(cfg: ExperimentConfig, verbose=True):
    if cfg.algo == "abc":
        return run_abc(cfg, verbose=verbose)
    import jax
    import jax.numpy as jnp

    from ..diag import (
        acceptance_rate,
        ess,
        gelman_rubin,
        pool_chains,
        summarize_chain,
    )
    from ..io import save_dataset, save_pmmh_run
    from ..mcmc import particle_mcmc_chains
    from ..observe import get_observation_model

    model = build_model(cfg)
    y, latent = generate_dataset(cfg)
    out_root = os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(out_root, exist_ok=True)
    save_dataset(os.path.join(out_root, "dataset.csv"), y)

    m = cfg.mcmc
    sigma0 = m.sigma0
    if cfg.warm_start_dir:
        # reference warm-restart recipe (tests/test_pmcmc_p.py:34-45)
        from ..io import warm_start

        ws_theta, ws_sigma = warm_start(cfg.warm_start_dir)
        theta0 = list(ws_theta)
        sigma0 = ws_sigma.tolist()
    else:
        theta0 = list(
            m.theta0 if m.theta0 is not None else cfg.data.theta_true
        )
        if m.infer_obs_param:
            theta0 = theta0 + [cfg.data.obs_param]
    obs_kind = (
        "gaussian" if cfg.data.observation == "gaussian" else "binomial"
    )
    obs = get_observation_model(obs_kind)

    # mu / n_population: explicit MCMCConfig values win; otherwise derived
    # from the dataset's initial state (the reference passes them explicitly
    # everywhere, e.g. tests/experiments/noise/noise_.1.py:40-41)
    if cfg.model.startswith("sir_subgroups"):
        k = cfg.subgroups
        y0 = np.asarray(cfg.data.y0, dtype=float).reshape(k, 3)
        n_population = jnp.asarray(
            y0.sum(axis=1) if m.n_population is None else m.n_population,
            jnp.float32,
        )
        mu = jnp.asarray(y0[:, 1] if m.mu is None else m.mu, jnp.float32)
    else:
        n_population = (
            float(np.sum(cfg.data.y0))
            if m.n_population is None
            else float(m.n_population)
        )
        mu = (
            float(cfg.data.y0[1] if cfg.model == "sir" else cfg.data.y0[2])
            if m.mu is None
            else float(m.mu)
        )

    n_particles = m.n_particles
    tuned_sd = None
    if m.auto_particles is not None:
        # self-size N by the pseudo-marginal rule (sd(logZ) <= target at
        # theta0) instead of trusting a hand-picked constant; see
        # epitpu.smc.tune_particles
        from ..smc import tune_particles

        theta_probe = jnp.asarray(theta0, jnp.float32)
        if m.infer_obs_param:
            probe_model_theta, probe_obs = theta_probe[:-1], float(theta_probe[-1])
        else:
            probe_model_theta, probe_obs = theta_probe, cfg.data.obs_param
        n_particles, tuned_sd = tune_particles(
            model, obs, jax.random.PRNGKey(cfg.seed + 4), jnp.asarray(y),
            probe_model_theta, probe_obs,
            target_sd=float(m.auto_particles),
            n_population=n_population, mu=mu,
            steps_per_unit=m.steps_per_unit, sampler=m.sampler,
            resample_every=m.resample_every,
            resample_threshold=m.resample_threshold,
        )
        met = tuned_sd <= float(m.auto_particles)
        if verbose or not met:
            rel = "<=" if met else ">"
            note = "" if met else (
                "  WARNING: target missed even at the max_particles cap — "
                "expect sticky pseudo-marginal mixing"
            )
            print(f"[pmmh] {cfg.name}: auto_particles -> N={n_particles} "
                  f"(sd(logZ)={tuned_sd:.2f} {rel} {m.auto_particles})"
                  f"{note}",
                  flush=True)

    common = dict(
        n_chains=m.n_chains,
        adaptive=m.adaptive,
        adapt_start=m.resolved_adapt_start(),
        sigma=None if sigma0 is None else jnp.asarray(sigma0, jnp.float32),
        n_iters=m.n_iters,
        obs_param=cfg.data.obs_param,
        infer_obs_param=m.infer_obs_param,
        n_particles=n_particles,
        n_population=n_population,
        mu=mu,
        steps_per_unit=m.steps_per_unit,
        resampling=m.resampling,
        resample_threshold=m.resample_threshold,
        resample_every=m.resample_every,
        sampler=m.sampler,
        target_acceptance=m.target_acceptance,
        pooled_adaptation=m.pooled_adaptation,
        store_trajectories=m.store_trajectories,
        # vmap-safe in-scan telemetry: single-chain runs stream the
        # reference's line, many-chain runs a chains-aggregated one
        log_every=m.log_every,
    )
    import contextlib

    prof = (
        jax.profiler.trace(cfg.profile_dir)
        if cfg.profile_dir
        else contextlib.nullcontext()
    )
    t0 = time.time()
    with prof:
        result = _run_pmmh_segmented(
            cfg,
            particle_mcmc_chains,
            model,
            obs,
            jnp.asarray(y),
            jnp.asarray(theta0, jnp.float32),
            common,
            out_root,
            verbose=verbose,
        )
    elapsed = time.time() - t0
    total_iters = m.n_chains * m.n_iters

    names = list(model.theta_names)
    if m.infer_obs_param:
        names.append("p_obs")
    comp_names = [
        {"s": "susceptible", "e": "exposed", "i": "infected", "r": "recovered"}.get(
            c, c  # subgroup models keep their s_0/i_0/... names
        )
        for c in model.compartments
    ]

    # Reference artifact layout: one run<i>/ directory per chain
    # (reference runs write run1/run2/run3).  That layout stops making
    # sense at production chain counts — the `production` preset runs
    # 2,048 chains, and 2,048 CSV directories is a filesystem DoS — so
    # past 8 chains only the first 3 get reference-layout dirs (enough
    # for reference-style 3-chain tooling) and the FULL chain set goes
    # into one compressed chains.npz.
    n_ref_dirs = m.n_chains if m.n_chains <= 8 else 3
    run_dirs = []
    for c in range(n_ref_dirs):
        run_dir = os.path.join(out_root, f"run{c + 1}")
        save_pmmh_run(
            run_dir,
            np.asarray(result.thetas[c]),
            np.asarray(result.log_likelihoods[c]),
            np.asarray(result.sampled_trajs[c]),
            compartment_names=comp_names,
        )
        run_dirs.append(run_dir)
    if m.n_chains > n_ref_dirs:
        np.savez_compressed(
            os.path.join(out_root, "chains.npz"),
            thetas=np.asarray(result.thetas),
            log_likelihoods=np.asarray(result.log_likelihoods),
        )

    report = {
        "name": cfg.name,
        "iters_total": total_iters,
        "n_particles": n_particles,
        **({"auto_particles_sd": tuned_sd} if tuned_sd is not None else {}),
        "seconds": elapsed,
        "iters_per_s": total_iters / elapsed,
        "acceptance": [
            acceptance_rate(np.asarray(result.thetas[c]))
            for c in range(m.n_chains)
        ],
        # burn-in is applied PER CHAIN before pooling (a flat slice would
        # discard only chain 0's burn-in)
        "summary": summarize_chain(
            pool_chains(result.thetas, burn_in=max(1, m.n_iters // 10)),
            names,
        ),
    }
    if m.n_chains >= 2:
        burn = m.n_iters // 5
        chains = np.asarray(result.thetas)[:, burn:, :]
        report["gelman_rubin"] = gelman_rubin(chains).tolist()
        report["ess"] = np.asarray(ess(chains)).tolist()
        # rank-normalized split variants (Vehtari et al. 2021) alongside the
        # reference-parity estimators: headline min-ESS claims use these —
        # the classic Geyer estimate has huge variance when ESS is small
        from ..diag import ess_rank, gelman_rubin_rank

        report["gelman_rubin_rank"] = gelman_rubin_rank(chains).tolist()
        report["ess_rank"] = np.asarray(ess_rank(chains)).tolist()

    if cfg.forecast_horizon > 0:
        # posterior-predictive forecast (reference tests/pred_tmps.py:55-104)
        if not m.store_trajectories:
            raise SystemExit(
                "--forecast needs stored trajectories (the forecast "
                "continues each draw from its last filtered state); set "
                "mcmc.store_trajectories=true"
            )
        from ..mcmc import forecast_from_result

        first = jax.tree_util.tree_map(lambda a: a[0], result)
        horizon = cfg.forecast_horizon
        burn = max(1, m.n_iters // 5)
        thin = max(1, (m.n_iters - burn) // 200)
        import dataclasses as _dc

        thinned = _dc.replace(
            first,
            thetas=first.thetas[burn:],
            sampled_trajs=first.sampled_trajs[burn:],
            log_likelihoods=first.log_likelihoods[burn:],
        )
        fc = forecast_from_result(
            model,
            jax.random.PRNGKey(cfg.seed + 1),
            thinned,
            horizon,
            infer_obs_param=m.infer_obs_param,
            thin=thin,
            steps_per_unit=m.steps_per_unit,
        )
        np.save(os.path.join(out_root, "forecast.npy"), np.asarray(fc))
        if cfg.make_plots:
            from ..viz import forecast_fan

            gdir = os.path.join(cfg.graphs_dir, cfg.name, "run1")
            forecast_fan(
                np.asarray(thinned.sampled_trajs)[::thin],
                np.asarray(fc)[:, 1:],
                gdir,
                truth=None,
            )

    if cfg.surface_points > 0:
        # likelihood-surface map around theta_true (reference
        # tests/testing_sbgrps.py:35-49); grid over the first two theta
        # components, remaining components pinned at truth
        from ..diag import high_likelihood_map, likelihood_surface, theta_grid
        from ..observe import get_observation_model as _gom

        tt = np.asarray(cfg.data.theta_true, dtype=float)
        if tt.shape[0] < 2:
            raise SystemExit(
                "--surface needs a model with at least 2 theta components "
                f"(got theta_true={tt.tolist()}): the surface is a 2-D grid "
                "over the first two components"
            )
        span = cfg.surface_span
        ranges = [
            (max(1e-3, tt[0] - span), tt[0] + span),
            (max(1e-3, tt[1] - span), tt[1] + span),
        ]
        grid2 = theta_grid(ranges, cfg.surface_points)
        if tt.shape[0] > 2:
            rest = np.broadcast_to(tt[2:], (grid2.shape[0], tt.shape[0] - 2))
            grid_full = np.concatenate([grid2, rest], axis=1).astype(np.float32)
        else:
            grid_full = grid2
        lls = likelihood_surface(
            model, obs, jax.random.PRNGKey(cfg.seed + 2), jnp.asarray(y),
            grid_full, obs_param=cfg.data.obs_param,
            n_particles=m.n_particles, n_population=n_population, mu=mu,
            steps_per_unit=m.steps_per_unit,
        )
        np.savetxt(
            os.path.join(out_root, "surface.csv"),
            np.concatenate([grid2, lls[:, None]], axis=1),
            delimiter=",",
            header=f"{names[0]},{names[1]},log_likelihood",
        )
        mask, _ = high_likelihood_map(grid_full, lls, quantile=0.5)
        report["surface"] = {
            "points": int(grid2.shape[0]),
            "argmax_theta": grid2[
                int(np.nanargmax(np.where(np.isfinite(lls), lls, -np.inf)))
            ].tolist(),
            "high_likelihood_count": int(mask.sum()),
        }
        if cfg.make_plots:
            from ..viz import surface_heatmap

            gdir = os.path.join(cfg.graphs_dir, cfg.name, "run1")
            surface_heatmap(
                grid2, lls, gdir, names=names[:2], truth=tt[:2].tolist()
            )

    if cfg.plot_particles:
        # one PF run's particle clouds + ancestry lines at the posterior-mean
        # theta (the reference's filter visualization,
        # tests/test_particles.py:78-95)
        from ..smc import particle_filter_jit
        from ..viz import particle_cloud_plot

        burn = max(1, m.n_iters // 5)
        theta_mean = np.asarray(result.thetas)[:, burn:, :].mean((0, 1))
        if m.infer_obs_param:
            viz_theta, viz_obs_param = theta_mean[:-1], float(theta_mean[-1])
        else:
            viz_theta, viz_obs_param = theta_mean, cfg.data.obs_param
        pf = particle_filter_jit(
            model, obs, jax.random.PRNGKey(cfg.seed + 3), jnp.asarray(y),
            jnp.asarray(viz_theta, jnp.float32), viz_obs_param,
            min(m.n_particles, 256), n_population, mu, m.steps_per_unit,
        )
        gdir = os.path.join(cfg.graphs_dir, cfg.name, "run1")
        path = particle_cloud_plot(pf.hidden, pf.ancestry, gdir)
        report["particle_plot"] = path

    if cfg.make_plots:
        from ..viz import multi_chain_traces, plot_pmmh_suite

        gdir = os.path.join(cfg.graphs_dir, cfg.name, "run1")
        first = jax.tree_util.tree_map(lambda a: a[0], result)
        plot_pmmh_suite(
            first,
            gdir,
            theta_names=names,
            latent_truth=latent if latent.shape[1] == len(comp_names) else None,
            compartment_names=comp_names,
            burn_in=min(100, m.n_iters // 5),
        )
        if m.n_chains >= 2:
            multi_chain_traces(
                np.asarray(result.thetas), gdir, names, suffix="_chains"
            )

    if verbose:
        import json

        print(json.dumps(report, indent=2, default=float))
    return result, report


# convergence gate thresholds for sweep levels (stated, not silent):
# rank-normalized split-R-hat below 1.1 and rank-ESS above 100 for EVERY
# theta component (Vehtari et al. 2021 criteria; the classic estimators
# are the fallback when the rank fields are absent)
CONVERGED_MAX_RHAT = 1.1
CONVERGED_MIN_ESS = 100.0


def run_sweep(sweep_name, cfgs, verbose=True):
    """Run every level of a sweep, then aggregate the cross-level analysis
    the reference performs by hand at the end of its noise / pobs / tmps
    studies (reference tests/test_noise.py:113-116, test_under.py:118-122,
    test_timepoints.py:98-101): per-parameter posterior MSE against
    theta_true, pooled ESS, and acceptance per level.  Writes
    ``<out_dir>/<sweep_name>/sweep_summary.json`` and a comparison plot."""
    import json

    from ..diag import pool_chains, posterior_mse

    cfgs = list(cfgs)
    levels = []
    for cfg in cfgs:
        t_level = time.perf_counter()
        result, report = run_experiment(cfg, verbose=verbose)
        wall_s = time.perf_counter() - t_level
        burn = max(1, cfg.mcmc.n_iters // 10)
        post = pool_chains(np.asarray(result.thetas), burn_in=burn)
        true = list(cfg.data.theta_true)
        pmse = [
            posterior_mse(t, post[:, j]) for j, t in enumerate(true)
        ]
        rhat = report.get("gelman_rubin")
        essv = report.get("ess")
        # explicit convergence gate (thresholds stated in the summary
        # JSON): silent "converged" claims are not allowed to stand.  The
        # RANK-NORMALIZED SPLIT estimators are the binding check — the
        # classic unsplit forms miss identical within-chain drift
        # (tests/test_diag.py::test_rank_rhat_detects_within_chain_trend)
        rhat_gate = report.get("gelman_rubin_rank") or rhat
        ess_gate = report.get("ess_rank") or essv
        converged = (
            bool(max(rhat_gate) < CONVERGED_MAX_RHAT and
                 min(ess_gate) > CONVERGED_MIN_ESS)
            if rhat_gate and ess_gate else None
        )
        levels.append({
            "name": cfg.name,
            # the swept value is the name suffix the sweep generator appends
            "level": cfg.name.rsplit("_", 1)[-1],
            "n_particles": report.get("n_particles"),
            "theta_true": true,
            "pmse": pmse,
            "pmse_mean": float(np.mean(pmse)),
            "acceptance": report["acceptance"],
            "ess": essv,
            "ess_rank": report.get("ess_rank"),
            "gelman_rubin": rhat,
            "gelman_rubin_rank": report.get("gelman_rubin_rank"),
            "converged": converged,
            "summary": report["summary"],
            "wall_s": wall_s,
            "iters_per_s": cfg.mcmc.n_iters * cfg.mcmc.n_chains / wall_s,
        })

    out_root = os.path.join(cfgs[0].out_dir, sweep_name)
    os.makedirs(out_root, exist_ok=True)
    summary = {
        "sweep": sweep_name,
        "convergence_criteria": {
            "max_rhat": CONVERGED_MAX_RHAT, "min_ess": CONVERGED_MIN_ESS,
        },
        "wall_note": (
            "wall_s/iters_per_s wrap run_experiment: the FIRST level of a "
            "sweep absorbs any one-time XLA compilation not already in the "
            "persistent cache, so its throughput under-reports relative to "
            "steady-state levels"
        ),
        "levels": levels,
    }
    with open(os.path.join(out_root, "sweep_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, default=float)
    if cfgs[0].make_plots:
        from ..viz import sweep_comparison_plot

        sweep_comparison_plot(
            levels, os.path.join(cfgs[0].graphs_dir, sweep_name)
        )
    if verbose:
        print(json.dumps(summary, indent=2, default=float))
    return summary


SWEEPS = {"noise": noise_sweep, "pobs": pobs_sweep, "tmps": tmps_sweep}

PRESETS = {
    "sir_underreported": lambda: ExperimentConfig(
        name="sir_underreported",
        data=DataConfig(observation="binomial", obs_param=0.1),
        mcmc=MCMCConfig(n_iters=1000, h=0.05, n_particles=100, n_chains=3),
    ),
    # the efficient-frontier configuration, productized: 2048 chains x 16
    # particles with pooled adaptation (h=0.6 on the pooled covariance),
    # resample_every=4, rbg tau-leap sampler, theta-only fast path.  The
    # pseudo-marginal sampler is exact at ANY particle count (unbiased
    # logZ), so small N costs only mixing.  The shape was the highest
    # stable cell of a joint chains x particles ESS/s sweep on an earlier
    # accelerator (N=8 and chains >= 3072 went seed-unstable via
    # outlier-init chains); it has not been re-swept on the GPU.  No
    # target-acceptance controller here: at production chain counts it
    # shrinks steps and a rare outlier init then can't walk home within
    # the run, collapsing min-component ESS — the fixed pooled h=0.6 was
    # the long-run optimum and robust across seeds.
    "production": lambda: ExperimentConfig(
        name="production",
        data=DataConfig(observation="binomial", obs_param=0.1),
        mcmc=MCMCConfig(
            n_iters=2000, h=0.6, n_particles=16, n_chains=2048,
            # self-size N from 16 upward by the sd(logZ) <= 1 rule: on the
            # flagship data this stops at 16 (sd=0.71) — identical to the
            # pinned frontier config — but a user pointing the preset at
            # SHARPER data automatically gets the larger N their
            # likelihood needs (the noise=0.05 level picks 128, where
            # pinned 16 mixes at acceptance 0.05)
            auto_particles=1.0,
            adaptive=True, adapt_start=16, pooled_adaptation=True,
            resample_every=4, sampler="fast_rbg",
            store_trajectories=False,
        ),
    ),
    "sir_noisy": lambda: ExperimentConfig(
        name="sir_noisy",
        data=DataConfig(observation="gaussian", obs_param=0.1),
        mcmc=MCMCConfig(n_iters=1000, h=0.05, n_particles=100, n_chains=3),
    ),
    "sir_infer_p": lambda: ExperimentConfig(
        name="sir_infer_p",
        data=DataConfig(observation="binomial", obs_param=0.1),
        mcmc=MCMCConfig(
            n_iters=1000, h=0.02, n_particles=100, n_chains=3,
            infer_obs_param=True,
        ),
    ),
    "seir_underreported": lambda: ExperimentConfig(
        name="seir_underreported",
        model="seir",
        data=DataConfig(
            y0=(4800.0, 0.0, 20.0, 0.0),
            theta_true=(4.0, 1.0, 1.0),
            observation="binomial",
            obs_param=0.1,
        ),
        mcmc=MCMCConfig(n_iters=1000, h=0.02, n_particles=100, n_chains=3),
    ),
    "sir_abc": lambda: ExperimentConfig(
        name="sir_abc",
        algo="abc",
        data=DataConfig(observation="none"),
        abc=ABCConfig(n_samples=100, threshold=150.0, prior_lo=0.0,
                      prior_hi=5.0),
    ),
    "sir_subgroups": lambda: ExperimentConfig(
        # per-group observations (reference ModelType.SIR_SUBGROUPS;
        # tests/test_pmcmc_sir_subgrps.py:24-39)
        name="sir_subgroups",
        model="sir_subgroups",
        subgroups=2,
        data=DataConfig(
            y0=(2000.0, 30.0, 0.0, 3000.0, 40.0, 0.0),
            theta_true=(5.0, 2.0, 1.0, 3.0, 0.5),
            t_max=10,
            observation="binomial",
            obs_param=0.1,
        ),
        mcmc=MCMCConfig(n_iters=500, h=0.02, n_particles=100, n_chains=2),
    ),
    "sir_subgroups2": lambda: ExperimentConfig(
        name="sir_subgroups2",
        model="sir_subgroups2",
        subgroups=2,
        data=DataConfig(
            y0=(2000.0, 30.0, 0.0, 3000.0, 40.0, 0.0),
            theta_true=(5.0, 2.0, 1.0, 3.0, 0.5),
            t_max=10,
            observation="binomial",
            obs_param=0.1,
        ),
        mcmc=MCMCConfig(n_iters=500, h=0.02, n_particles=100, n_chains=2),
    ),
}


def main(argv=None):
    import epitpu

    epitpu.enable_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--config", type=str, default=None, help="JSON config path")
    ap.add_argument("--sweep", choices=sorted(SWEEPS), default=None)
    ap.add_argument("--dump-config", action="store_true")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument(
        "--surface", type=int, default=None, metavar="P",
        help="also evaluate the PF likelihood on a PxP (beta, gamma) grid "
        "around theta_true: surface.csv + heatmap (reference "
        "likelihood-map workflow)",
    )
    ap.add_argument(
        "--resample-every", type=int, default=None, metavar="K",
        help="static schedule: resample only on every K-th observation "
        "step (weights carried between; skips the resampling compute on "
        "off-steps)",
    )
    ap.add_argument(
        "--resample-threshold", type=float, default=None, metavar="ALPHA",
        help="ESS-triggered conditional resampling: resample only when "
        "particle ESS < ALPHA*N (1.0 = reference always-resample; 0.5 = "
        "standard SMC choice, lower-variance likelihood estimate)",
    )
    ap.add_argument(
        "--auto-particles", type=float, default=None, metavar="SD",
        help="self-size the particle count before the run: double N from "
        "16 until the PF log-likelihood sd at theta0 drops under SD (the "
        "pseudo-marginal rule, ~1.0; overrides --particles)",
    )
    ap.add_argument(
        "--target-acceptance", type=float, default=None, metavar="A",
        help="Robbins-Monro self-tuning of the proposal scale toward this "
        "realized acceptance rate (~0.35 was the ESS/s optimum at 4096 "
        "particles); replaces per-experiment h tuning",
    )
    ap.add_argument(
        "--plot-particles", action="store_true",
        help="run one particle filter at the posterior-mean theta and plot "
        "particle clouds + ancestry lines (reference filter visualization)",
    )
    ap.add_argument(
        "--forecast", type=int, default=None, metavar="HORIZON",
        help="posterior-predictive forecast this many time units past the "
        "data (reference pred_tmps.py)",
    )
    ap.add_argument(
        "--warm-start", type=str, default=None, metavar="RUN_DIR",
        help="seed theta0/sigma0 from a previous run directory "
        "(reference warm-restart recipe)",
    )
    ap.add_argument(
        "--checkpoint-every", type=int, default=None, metavar="K",
        help="segment the run every K iterations: save a resumable "
        "full-state checkpoint and print live progress",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="continue bit-compatibly from <out>/<name>/checkpoint.npz",
    )
    ap.add_argument(
        "--log-every", type=int, default=None, metavar="K",
        help="single-chain runs: stream the in-scan telemetry line every "
        "K iterations",
    )
    ap.add_argument(
        "--profile", type=str, default=None, metavar="DIR",
        help="record a jax.profiler trace of the sampler into DIR "
        "(view with TensorBoard / xprof)",
    )
    ap.add_argument(
        "--multihost", action="store_true",
        help="join a multi-host JAX runtime before running (env triple "
        "EPITPU_COORDINATOR/EPITPU_NUM_PROCESSES/EPITPU_PROCESS_ID, or "
        "cloud auto-detection; see epitpu.dist.multihost)",
    )
    args = ap.parse_args(argv)

    if args.multihost:
        # must happen before anything touches a JAX backend
        from ..dist import initialize_multihost

        initialize_multihost()

    if args.sweep:
        cfgs = []
        for cfg in SWEEPS[args.sweep]():
            _apply_overrides(cfg, args)
            cfgs.append(cfg)
        run_sweep(args.sweep, cfgs)
        return 0

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        cfg = PRESETS[args.preset or "sir_underreported"]()
    _apply_overrides(cfg, args)
    if args.dump_config:
        print(cfg.to_json())
        return 0
    run_experiment(cfg)
    return 0


def _apply_overrides(cfg, args):
    if args.iters is not None:
        cfg.mcmc.n_iters = args.iters
    if args.chains is not None:
        cfg.mcmc.n_chains = args.chains
    if args.particles is not None:
        cfg.mcmc.n_particles = args.particles
    if args.no_plots:
        cfg.make_plots = False
    if args.resample_threshold is not None:
        cfg.mcmc.resample_threshold = args.resample_threshold
    if args.resample_every is not None:
        cfg.mcmc.resample_every = args.resample_every
    if args.surface is not None:
        cfg.surface_points = args.surface
    if args.plot_particles:
        cfg.plot_particles = True
    if args.target_acceptance is not None:
        cfg.mcmc.target_acceptance = args.target_acceptance
    if args.auto_particles is not None:
        cfg.mcmc.auto_particles = args.auto_particles
    if args.forecast is not None:
        cfg.forecast_horizon = args.forecast
    if args.warm_start is not None:
        cfg.warm_start_dir = args.warm_start
    if args.checkpoint_every is not None:
        cfg.checkpoint_every = args.checkpoint_every
    if args.resume:
        cfg.resume = True
    if args.log_every is not None:
        cfg.mcmc.log_every = args.log_every
    if args.profile is not None:
        cfg.profile_dir = args.profile


if __name__ == "__main__":
    sys.exit(main())
