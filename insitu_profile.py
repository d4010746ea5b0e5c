"""In-situ phase profile of the REAL compiled PMMH program.

Round 2's ``profile_bench.py`` timed each phase in isolation; isolated
phases lose cross-phase XLA fusion, so the reconstruction over-counted
(negative overhead) and its "resampling dominates" conclusion was wrong.
This harness measures the actual production program:

1. compile the bench PMMH workload (16 vmapped chains x 4096 particles,
   the ``bench.py`` configuration) and parse the optimized HLO: every
   instruction carries ``metadata={op_name="jit(..)/<named_scope path>/.."}``
   and every ``fusion.N`` maps to a ``%fused_computation.N`` whose
   instructions' scope paths attribute the fusion to a pipeline phase
   (``pf_propagate`` / ``pf_weight`` / ``pf_resample`` / ``path_sample`` /
   ``mh_propose`` / ``mh_accept`` / ``adapt_welford`` — the
   ``jax.named_scope`` annotations in epitpu.smc.filter / epitpu.mcmc.pmmh);
2. run the same executable under ``jax.profiler.trace`` and aggregate the
   DEVICE-side event durations by instruction name;
3. join (1) and (2): true per-phase device-time fractions of the program
   that actually ships, written to PROFILE_insitu.json.

Fusions spanning several scopes are attributed fractionally by their
constituent instructions' scope histogram (instruction count — a proxy, but
only a few percent of device time lands in mixed fusions).  Within
``pf_propagate`` the RNG share is split out by matching threefry/rbg/bit ops.

Usage: python insitu_profile.py [--iters 24] [--chains 16]
       [--particles 4096] [--out PROFILE_insitu.json]
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import shutil
import tempfile

# Order matters: classify() returns the FIRST phase found in an op's scope
# path, so the fine-grained body scopes come first and the container scopes
# (pf_scan / pmmh_scan, which wrap entire lax.scan calls and therefore
# appear in every body op's path) come last — a body op classified by its
# inner scope, scan bookkeeping (carry/stacking dynamic-update-slices, which
# carry only the container scope) classified to its scan.
PHASES = (
    "pf_propagate",
    "pf_weight",
    "pf_resample",
    "pf_loglik",
    "pf_init",
    "path_sample",
    "mh_propose",
    "mh_accept",
    "adapt_welford",
    "pmmh_init",
    "pf_scan",
    "pmmh_scan",
)

RNG_OP_RE = re.compile(
    r"threefry|rng-bit-generator|rng_bit|random_bits|shift-(left|right)"
    r"|xor(?![a-z])", re.I
)


def build_workload(n_chains, n_iters, n_particles, sampler, steps_per_unit,
                   resample_threshold=1.0, resample_every=1, adaptive=False,
                   adapt_start=10**9, h=0.05, store_trajectories=True):
    """The exact bench.py workload, returned as (jitted fn, args)."""
    import jax
    import jax.numpy as jnp

    from epitpu.mcmc.pmmh import _STATIC_NAMES, particle_mcmc
    from epitpu.models import sir_model
    from epitpu.cli.configs import ExperimentConfig
    from epitpu.cli.run import generate_dataset
    from epitpu.observe import get_observation_model

    y = jnp.asarray(generate_dataset(ExperimentConfig())[0])  # flagship
    model = sir_model()
    obs = get_observation_model("binomial")

    def run(keys):
        f = lambda k: particle_mcmc(
            model, obs, k, y, jnp.array([2.0, 1.0]), h,
            adaptive=adaptive, adapt_start=adapt_start, n_iters=n_iters,
            obs_param=0.1, n_particles=n_particles, n_population=4820,
            mu=20.0, steps_per_unit=steps_per_unit, n_init_attempts=2,
            sampler=sampler, resample_threshold=resample_threshold,
            resample_every=resample_every,
            store_trajectories=store_trajectories,
        )
        return jax.vmap(f)(keys).thetas

    keys = jax.random.split(jax.random.PRNGKey(1), n_chains)
    return jax.jit(run), keys


def parse_hlo_phases(hlo_text):
    """Map every instruction name (and fusion) to a phase histogram.

    Returns {instr_name: {phase_or_'other': weight}} with weights summing
    to 1 per instruction.  Fusions inherit the scope histogram of their
    called computation's instructions; RNG-looking ops inside pf_propagate
    are classified 'pf_propagate_rng'.
    """
    # computation name -> list of (op_name_path, is_rng)
    comp_ops = collections.defaultdict(list)
    # instruction -> called computation (for fusions)
    fusion_calls = {}
    # instruction -> own metadata path
    own_path = {}

    cur_comp = None
    instr_re = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=")
    comp_re = re.compile(r"^%?([\w.\-]+)\s+\(.*\)\s*->.*\{")
    meta_re = re.compile(r'metadata=\{[^}]*op_name="([^"]*)"')
    calls_re = re.compile(r"calls=%?([\w.\-]+)")

    for line in hlo_text.splitlines():
        mc = comp_re.match(line)
        if mc and "=" not in line.split("(")[0]:
            cur_comp = mc.group(1)
            continue
        mi = instr_re.match(line)
        if not mi or cur_comp is None:
            continue
        name = mi.group(1)
        mm = meta_re.search(line)
        path = mm.group(1) if mm else ""
        is_rng = bool(RNG_OP_RE.search(line.split("metadata")[0]))
        comp_ops[cur_comp].append((path, is_rng))
        own_path[name] = path
        if " fusion(" in line:
            mcall = calls_re.search(line)
            if mcall:
                fusion_calls[name] = mcall.group(1)

    def classify(path, is_rng=False):
        for ph in PHASES:
            if f"/{ph}" in path or path.startswith(ph):
                if ph == "pf_propagate" and is_rng:
                    return "pf_propagate_rng"
                return ph
        return "other"

    instr_phase = {}
    for name, path in own_path.items():
        comp = fusion_calls.get(name)
        if comp and comp in comp_ops:
            hist = collections.Counter(
                classify(p, r) for p, r in comp_ops[comp]
            )
            tot = sum(hist.values())
            instr_phase[name] = {k: v / tot for k, v in hist.items()}
        else:
            instr_phase[name] = {classify(path): 1.0}
    return instr_phase


_GPU_PLANE = re.compile(r"/device:GPU:\d+")


def device_event_durations(trace_dir):
    """Sum device-side event durations (us) by instruction name, over the
    GPU device planes (processes named ``/device:GPU:N``)."""
    files = glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
    )
    if not files:
        raise RuntimeError(f"no trace files under {trace_dir}")
    durs = collections.Counter()
    device_pids = set()
    for fn in files:
        with gzip.open(fn, "rt") as fh:
            doc = json.load(fh)
        ev = doc.get("traceEvents", [])
        for e in ev:
            if e.get("ph") == "M" and e.get("name") == "process_name":
                if _GPU_PLANE.search(str(e.get("args", {}).get("name", ""))):
                    device_pids.add(e.get("pid"))
        for e in ev:
            name = str(e.get("name", ""))
            if (
                e.get("ph") == "X"
                and e.get("pid") in device_pids
                # keep LEAF ops only: jit_* (whole-program), while/
                # conditional/call (control-flow containers) SPAN their
                # children's events and would double-count
                and not name.startswith(
                    ("jit_", "while", "conditional", "call")
                )
            ):
                durs[name] += float(e.get("dur", 0.0))
    if not device_pids:
        raise RuntimeError(f"no /device:GPU:N plane in the trace {trace_dir}")
    return durs


def main():
    import epitpu

    epitpu.enable_compilation_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--steps-per-unit", type=int, default=20)
    ap.add_argument("--sampler", default="fast_rbg")
    ap.add_argument("--resample-threshold", type=float, default=1.0)
    ap.add_argument("--resample-every", type=int, default=1)
    ap.add_argument("--no-store-trajectories", action="store_true",
                    help="theta-only fast path (production preset): no "
                    "filter history, no path sampling, no traj stacking")
    ap.add_argument("--out", default="PROFILE_insitu.json")
    args = ap.parse_args()

    import jax

    print("building workload...", flush=True)
    fn, keys = build_workload(
        args.chains, args.iters, args.particles, args.sampler,
        args.steps_per_unit, args.resample_threshold, args.resample_every,
        store_trajectories=not args.no_store_trajectories,
    )
    print("lowering...", flush=True)
    lowered = fn.lower(keys)
    print("compiling...", flush=True)
    compiled = lowered.compile()
    print("parsing HLO...", flush=True)
    instr_phase = parse_hlo_phases(compiled.as_text())

    # warm up (also materializes the executable), then trace one real run
    print("warmup run...", flush=True)
    jax.block_until_ready(fn(keys))
    print("tracing...", flush=True)
    import time

    trace_dir = tempfile.mkdtemp(prefix="epitpu_insitu_")
    try:
        t0 = time.perf_counter()
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(fn(keys))
        wall_s = time.perf_counter() - t0
        durs = device_event_durations(trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)

    phase_us = collections.Counter()
    unmatched_us = 0.0
    for name, us in durs.items():
        hist = instr_phase.get(name)
        if hist is None:
            unmatched_us += us
            continue
        for ph, w in hist.items():
            phase_us[ph] += us * w
    total_us = sum(durs.values())

    top = durs.most_common(12)
    doc = {
        "workload": {
            "chains": args.chains, "iters": args.iters,
            "particles": args.particles, "sampler": args.sampler,
            "steps_per_unit": args.steps_per_unit,
            "resample_threshold": args.resample_threshold,
            "resample_every": args.resample_every,
            "store_trajectories": not args.no_store_trajectories,
        },
        "total_device_us": round(total_us, 1),
        "wall_s": round(wall_s, 3),
        "per_iter_us": round(total_us / max(args.iters, 1), 1),
        "phases_pct": {
            ph: round(100.0 * us / total_us, 2)
            for ph, us in sorted(
                phase_us.items(), key=lambda kv: -kv[1]
            )
        },
        "unmatched_pct": round(100.0 * unmatched_us / total_us, 2),
        "top_ops_us": [
            {"op": n, "us": round(us, 1),
             "phases": instr_phase.get(n, {"?": 1.0})}
            for n, us in top
        ],
        "note": (
            "Device-side HLO event durations from an in-situ jax.profiler "
            "trace of the production PMMH program, attributed to pipeline "
            "phases via named_scope op_name metadata in the optimized HLO "
            "(fusions weighted by their constituent-instruction scope "
            "histogram)."
        ),
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps({"per_iter_us": doc["per_iter_us"],
                      "phases_pct": doc["phases_pct"],
                      "unmatched_pct": doc["unmatched_pct"]}))


if __name__ == "__main__":
    main()
