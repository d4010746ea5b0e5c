"""Per-phase PMMH step profiler -> PROFILE.json  (VERDICT round-1 item #10).

Times each phase of one PMMH iteration in isolation on the real device, at
several vmapped chain counts, so the headline BENCH number can be decomposed
into its parts and the remaining headroom located.  Phases (one PMMH iter =
1 proposal + (T-1) filter steps + 1 path sample + O(d) MH/Welford scalars;
each filter step = weight + resample-gather + steps_per_unit tau-leap
substeps):

  * propagate  — ``sim.tauleap.advance`` of the whole [chains, N, C] cloud by
                 one time unit (steps_per_unit substeps), the reference's
                 joblib Gillespie fan-out (reference pmcmc.py:200-220)
  * rng        — just the raw RNG draws propagate consumes (split + uniform +
                 normal per substep), to show how much of propagate is RNG
  * weight     — observation log-likelihood over the cloud
                 (reference pmcmc.py:179-181)
  * resample   — systematic compare-reduce resampling + ancestor gather
                 (reference pmcmc.py:185-199)
  * path       — ancestral path sampler over a [T, N] ancestry
                 (reference pmcmc.py:236-248)
  * filter_step— one fused weight+resample+propagate scan step (the actual
                 scan body of smc.filter.particle_filter)
  * pmmh_iter  — measured whole-iteration cost from particle_mcmc_chains

Each phase runs as a jitted ``lax.scan`` of REPS repetitions inside ONE
compiled program (per-dispatch overhead would otherwise swamp sub-ms
kernels); reported time is scan_time / REPS.

Usage:  python profile_bench.py [--chains 16 32 64] [--particles 4096]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _timed(fn, *args):
    """Compile, then time one blocking call."""
    import jax

    r = jax.block_until_ready(fn(*args))  # compile + warmup
    t0 = time.perf_counter()
    r = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, r


def profile(n_chains, n_particles, steps_per_unit, reps, t_len=15):
    import jax
    import jax.numpy as jnp

    from epitpu.mcmc import particle_mcmc_chains
    from epitpu.models import sir_model
    from epitpu.observe import get_observation_model
    from epitpu.ode import sir_simulate_discrete
    from epitpu.sim.tauleap import advance
    from epitpu.smc.paths import sample_path
    from epitpu.smc.resample import systematic_resample

    model = sir_model()
    obs = get_observation_model("binomial")
    theta = jnp.array([2.0, 1.0])

    t = np.linspace(0, 14, 100)
    df = sir_simulate_discrete((4800.0, 20.0, 0.0), t, 2.0, 1.0)
    latent = df[["susceptible", "infected", "removed"]].to_numpy()
    rng = np.random.default_rng(42)
    y = jnp.asarray(rng.binomial(np.round(latent).astype(int), 0.1).astype(np.float32))

    key = jax.random.PRNGKey(0)
    x0 = jnp.tile(
        jnp.array([4800.0, 20.0, 0.0]), (n_chains, n_particles, 1)
    )
    n_r = model.num_reactions

    # ---- phase kernels, each scanned REPS times inside one jit ----
    def scan_reps(body):
        @jax.jit
        def run(x, k):
            keys = jax.random.split(k, reps)
            out, _ = jax.lax.scan(lambda c, kk: (body(c, kk), None), x, keys)
            return out
        return run

    def propagate_body(x, k):
        return advance(model, k, x, theta, 1.0, steps_per_unit, "fast")

    def rng_body(x, k):
        # what the fast sampler draws per substep: split + uniform + normal
        def sub(c, kk):
            ku, kz = jax.random.split(kk)
            u = jax.random.uniform(ku, (n_chains, n_particles, n_r))
            z = jax.random.normal(kz, (n_chains, n_particles, n_r))
            return c + jnp.sum(u) - jnp.sum(z), None
        acc, _ = jax.lax.scan(sub, jnp.float32(0.0),
                              jax.random.split(k, steps_per_unit))
        return x + acc * 0.0

    def weight_body(x, k):
        logw = obs(y[3], model.observe_map(x), 0.1)  # [chains, N]
        return x + jnp.mean(logw)[None, None, None] * 0.0

    def resample_body(x, k):
        logw = obs(y[3], model.observe_map(x), 0.1)
        anc, _ = systematic_resample(k, logw)  # [chains, N]
        return jnp.take_along_axis(x, anc[..., None], axis=1)

    def filter_step_body(carry, k):
        x = carry
        k_res, k_prop = jax.random.split(k)
        logw = obs(y[3], model.observe_map(x), 0.1)
        anc, _ = systematic_resample(k_res, logw)
        x_res = jnp.take_along_axis(x, anc[..., None], axis=1)
        return advance(model, k_prop, x_res, theta, 1.0, steps_per_unit, "fast")

    phases = {}
    for name, body in [
        ("propagate", propagate_body),
        ("rng", rng_body),
        ("weight", weight_body),
        ("resample", resample_body),
        ("filter_step", filter_step_body),
    ]:
        dt, _ = _timed(scan_reps(body), x0, key)
        phases[name] = dt / reps
        print(f"[profile] chains={n_chains:4d}  {name:<12s} "
              f"{phases[name] * 1e6:10.1f} us/step", flush=True)

    # path sampler: vmapped over chains, scanned
    hidden = jnp.zeros((n_chains, t_len, n_particles, 3))
    ancestry = jnp.zeros((n_chains, t_len, n_particles), jnp.int32)

    def path_body(c, k):
        ks = jax.random.split(k, n_chains)
        traj = jax.vmap(sample_path)(ks, hidden, ancestry)  # [chains, T, C]
        return c + jnp.sum(traj) * 0.0

    dt, _ = _timed(scan_reps(path_body), jnp.float32(0.0), key)
    phases["path"] = dt / reps
    print(f"[profile] chains={n_chains:4d}  {'path':<12s} "
          f"{phases['path'] * 1e6:10.1f} us/step", flush=True)

    # whole PMMH iteration, measured end-to-end
    n_iters = max(reps // 2, 16)

    def pmmh(k):
        return particle_mcmc_chains(
            model, obs, k, y, theta, 0.05, n_chains=n_chains,
            n_iters=n_iters, obs_param=0.1, n_particles=n_particles,
            n_population=4820, mu=20.0, steps_per_unit=steps_per_unit,
            n_init_attempts=2,
        ).thetas

    dt, _ = _timed(pmmh, key)
    phases["pmmh_iter"] = dt / n_iters
    print(f"[profile] chains={n_chains:4d}  {'pmmh_iter':<12s} "
          f"{phases['pmmh_iter'] * 1e6:10.1f} us/iter", flush=True)

    t_steps = t_len - 1
    # reconstruction of one iteration from the isolated phases
    recon = t_steps * phases["filter_step"] + phases["path"]
    row = {
        "chains": n_chains,
        "us": {k: round(v * 1e6, 2) for k, v in phases.items()},
        "filter_steps_per_iter": t_steps,
        "recon_iter_us": round(recon * 1e6, 2),
        "overhead_us": round((phases["pmmh_iter"] - recon) * 1e6, 2),
        "iters_per_s_aggregate": round(n_chains / phases["pmmh_iter"], 2),
        "rng_share_of_propagate": round(phases["rng"] / phases["propagate"], 3),
    }
    return row


def main():
    import epitpu

    epitpu.enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--steps-per-unit", type=int, default=20)
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--out", default="PROFILE.json")
    args = ap.parse_args()

    import jax

    rows = [
        profile(c, args.particles, args.steps_per_unit, args.reps)
        for c in args.chains
    ]
    doc = {
        "backend": str(jax.default_backend()),
        "device": str(jax.devices()[0]),
        "n_particles": args.particles,
        "steps_per_unit": args.steps_per_unit,
        "reps": args.reps,
        "note": (
            "us = per-invocation time of each isolated phase at the given "
            "vmapped chain count (scan of `reps` inside one jit). "
            "recon_iter_us = 14*filter_step + path; overhead_us = measured "
            "pmmh_iter - recon (proposal, MH, Welford, scan bookkeeping). "
            "CAVEAT: isolated phases lose the cross-phase XLA fusion of the "
            "real fused program, so recon can EXCEED the measured iteration "
            "(negative overhead_us); treat phase shares as upper bounds. "
            "For ground truth use the in-situ jax.profiler breakdown in "
            "PROFILE_insitu.json (insitu_profile.py)."
        ),
        "rows": rows,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps({"profile": rows}, indent=None))


if __name__ == "__main__":
    main()
