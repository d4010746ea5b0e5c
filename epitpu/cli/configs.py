"""Dataclass experiment configuration — the reference has no config system:
constants sit at the top of ~20 scripts and grids are encoded as one file per
grid point (reference tests/experiments/noise/noise_.1.py etc., SURVEY.md
section 5).  One config type + a sweep helper replaces all of that.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class DataConfig:
    """Synthetic-dataset generation (reference data-gen blocks, e.g.
    tests/test_pmcmc_noisy.py:20-29)."""

    y0: Tuple[float, ...] = (4800.0, 20.0, 0.0)
    theta_true: Tuple[float, ...] = (2.0, 1.0)
    t_max: int = 14
    grid_points: int = 100
    observation: str = "binomial"  # "binomial" | "gaussian" | "none"
    obs_param: float = 0.1
    seed: int = 42
    # subgroup models: y0 is [K*3] flat, beta part of theta_true row-major
    aggregate_obs: bool = False


@dataclasses.dataclass
class MCMCConfig:
    n_iters: int = 1000
    h: float = 0.05
    adaptive: bool = False
    # None: auto-resolve to ``min(1000, n_iters // 5)`` so adaptation always
    # engages within the configured run.  (The reference hardcodes 1000 and
    # runs 6000-iteration grids, reference tests/experiments/noise/noise_.1.py:36
    # and pmcmc.py:327; a fixed 1000 default silently disabled adaptation for
    # any run with n_iters <= 1000.)
    adapt_start: Optional[int] = None
    sigma0: Optional[Sequence[Sequence[float]]] = None
    n_particles: int = 100
    n_chains: int = 1
    infer_obs_param: bool = False
    steps_per_unit: int = 20
    resampling: str = "systematic"
    # ESS fraction alpha for conditional resampling: resample only when the
    # particle ESS drops below alpha * N.  1.0 = the reference's
    # always-resample semantics (default); 0.5 is the standard SMC choice —
    # lower marginal-likelihood variance AND less resampling work.
    resample_threshold: float = 1.0
    # static resampling schedule: resample on every k-th observation step
    # (weights carried between).  Unlike the ESS trigger this skips the
    # resampling COMPUTE on off-steps (real lax.cond on the un-batched step
    # index).  1 = resample every step.
    resample_every: int = 1
    # Robbins-Monro self-tuning of the proposal scale toward this realized
    # acceptance rate (diminishing adaptation; replaces the reference's
    # per-script hand-tuned h).  A sweep on an earlier accelerator put the
    # ESS/s optimum at acceptance ~0.25-0.40 for the 4096-particle
    # flagship; 0.35 is a good target there.  None = fixed scale
    # (reference behavior).
    target_acceptance: Optional[float] = None
    # tau-leap binomial sampler: "fast" (threefry), "fast_rbg" (XLA's
    # RngBitGenerator bits — same law; its speed against threefry is not
    # measured on the GPU), or "exact" (jax.random.binomial, validation)
    sampler: str = "fast"
    # not None: SELF-SIZE the particle count before the run — double from
    # 16 until the PF log-likelihood sd at theta0 drops under this target
    # (the pseudo-marginal tuning rule, sd(logZ) ~ 1; epitpu.smc
    # .tune_particles).  Overrides n_particles with the measured choice,
    # recorded in the report.  The reference hand-picks 100 everywhere.
    auto_particles: Optional[float] = None
    # pool the adaptive-proposal Welford statistics across ALL parallel
    # chains via collectives each iteration (epitpu.mcmc.adaptive.Welford
    # .pooled) — many cheap chains then share one well-estimated covariance.
    # This is half of the `production` preset's configuration (bench.py
    # eff_* section); no reference counterpart.
    pooled_adaptation: bool = False
    # False: theta-only fast path — the filter records no particle history,
    # no ancestral path is sampled, and no [T, C] trajectory is stacked per
    # iteration.  Theta chains are bit-identical to a storing run; forecast
    # and trajectory plots/CSVs require True.
    store_trajectories: bool = True
    # emit the reference-style live telemetry line (iter, acceptance ratio,
    # theta, log zeta) every K iterations from inside the compiled scan
    # (reference pmcmc.py:320-321, 405-406); many-chain runs stream a
    # chains-aggregated line
    log_every: int = 0
    # None: derive from data.y0 (sum -> n_population, initial infected -> mu);
    # set explicitly to override (sequences allowed for subgroup models)
    mu: Optional[float] = None
    n_population: Optional[float] = None
    theta0: Optional[Tuple[float, ...]] = None  # default: theta_true

    def resolved_adapt_start(self) -> int:
        """The effective ``adapt_start``: the explicit value if set, else
        ``min(1000, n_iters // 5)`` — guaranteed to engage before the run
        ends (reference semantics: adaptation after iteration ``adapt_start``,
        reference pmcmc.py:327-328)."""
        if self.adapt_start is not None:
            return self.adapt_start
        return min(1000, max(1, self.n_iters // 5))


@dataclasses.dataclass
class ABCConfig:
    """ABC rejection settings (reference abc_algo.py:17 call sites:
    tests/simulated_data.py:39-52, tests/test_abc_sir.py:43)."""

    n_samples: int = 100
    threshold: float = 150.0
    prior_lo: float = 0.0
    prior_hi: float = 5.0
    batch_size: int = 512
    steps_per_unit: int = 20


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "sir_underreported"
    model: str = "sir"  # sir | seir | sir_subgroups | sir_subgroups2
    algo: str = "pmmh"  # pmmh | abc
    subgroups: int = 2
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mcmc: MCMCConfig = dataclasses.field(default_factory=MCMCConfig)
    abc: ABCConfig = dataclasses.field(default_factory=ABCConfig)
    out_dir: str = "data"
    graphs_dir: str = "graphs"
    seed: int = 0
    make_plots: bool = True
    forecast_horizon: int = 0  # >0: posterior-predictive forecast to t=H
    warm_start_dir: str = ""  # previous run dir to seed theta0/sigma0 from
    # >0: run PMMH in segments of this many iterations, saving a resumable
    # full-state checkpoint (<out_dir>/<name>/checkpoint.npz) and printing a
    # live progress line after each segment
    checkpoint_every: int = 0
    resume: bool = False  # continue from the checkpoint if one exists
    profile_dir: str = ""  # wrap the sampler in jax.profiler.trace(dir)
    # >0: also evaluate the PF log-likelihood on a surface_points^2 grid of
    # the first two theta components around theta_true, saving surface.csv
    # + a heatmap (the reference's likelihood-map workflow,
    # tests/testing_sbgrps.py:35-49)
    surface_points: int = 0
    surface_span: float = 1.5
    # run ONE particle filter at the posterior-mean theta and plot the
    # particle clouds + ancestry lines (the reference's filter
    # visualization, tests/test_particles.py:78-95)
    plot_particles: bool = False

    def to_json(self):
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text):
        raw = json.loads(text)
        raw["data"] = DataConfig(**raw.get("data", {}))
        raw["mcmc"] = MCMCConfig(**raw.get("mcmc", {}))
        raw["abc"] = ABCConfig(**raw.get("abc", {}))
        return ExperimentConfig(**raw)


def sweep(base: ExperimentConfig, field_path: str, values):
    """Yield copies of ``base`` with a (dotted) field swept over ``values`` —
    replaces the reference's file-per-gridpoint experiment dirs
    (tests/experiments/{noise,pobs,tmps}/)."""
    for v in values:
        cfg = dataclasses.replace(base)
        cfg.data = dataclasses.replace(base.data)
        cfg.mcmc = dataclasses.replace(base.mcmc)
        obj = cfg
        *parents, leaf = field_path.split(".")
        for p in parents:
            obj = getattr(obj, p)
        setattr(obj, leaf, v)
        cfg.name = f"{base.name}_{field_path.split('.')[-1]}_{v}"
        yield cfg


# Presets mirroring the reference's experiment grids
def noise_sweep(base=None):
    """reference tests/experiments/noise/: Gaussian noise levels .05-.3."""
    base = base or ExperimentConfig(
        name="noise",
        data=DataConfig(observation="gaussian"),
        mcmc=MCMCConfig(adaptive=True, n_particles=100, h=10.0),
    )
    for cfg in sweep(base, "data.obs_param", [0.05, 0.1, 0.15, 0.2, 0.25, 0.3]):
        cfg.mcmc.theta0 = None
        yield cfg


def pobs_sweep(base=None):
    """reference tests/experiments/pobs/: reporting probs .005-.075."""
    base = base or ExperimentConfig(
        name="pobs",
        data=DataConfig(observation="binomial"),
        mcmc=MCMCConfig(adaptive=True, n_particles=100, h=5.0),
    )
    yield from sweep(base, "data.obs_param", [0.005, 0.01, 0.025, 0.05, 0.075])


def tmps_sweep(base=None):
    """reference tests/experiments/tmps/: truncated series T in {11, 7, 3}."""
    base = base or ExperimentConfig(
        name="tmps",
        data=DataConfig(observation="binomial"),
        mcmc=MCMCConfig(adaptive=True, n_particles=100, h=5.0),
    )
    yield from sweep(base, "data.t_max", [11, 7, 3])
