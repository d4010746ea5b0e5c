"""Arithmetic that must be exact on every backend.

The tau-leap state is float32 holding integers.  A default-precision
float32 ``dot_general`` may run in TF32 on a GPU, which keeps integers
exact only below 2^11, while populations reach 10^6.  So the tau-leap
writes its small matrix products as unrolled sums, and every remaining dot
on the proposal, subgroup-rate and ODE paths pins ``Precision.HIGHEST``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import _dot_generals
from epitpu.models import seir_model, sir_model, sir_subgroups_model
from epitpu.sim import advance, event_counts, substep
from epitpu.sim.tauleap import _static_matmul

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGHEST = jax.lax.Precision.HIGHEST


def _sirs_competing():
    """S -> I, I -> R and I -> S: two reactions share the source I, so the
    tau-leap takes its competing-hazard path."""
    from epitpu.models.base import make_model

    def rates(x, theta):
        s, i = x[..., 0], x[..., 1]
        n = jnp.sum(x, axis=-1)
        return jnp.stack(
            [theta[0] * s * i / n, theta[1] * i, theta[2] * i], axis=-1
        )

    return make_model(
        "sirs_competing", ("s", "i", "r"),
        [[-1, 1, 0], [0, -1, 1], [1, -1, 0]], [0, 1, 1], rates, 3,
        ("beta", "gamma", "delta"),
    )


def _jaxpr_of(case):
    key = jax.random.PRNGKey(0)
    if case in ("sir_substep", "sir_advance", "seir_advance",
                "competing_advance"):
        model = {"sir": sir_model, "seir": seir_model,
                 "competing": _sirs_competing}[case.split("_")[0]]()
        c = model.num_compartments
        x = jnp.full((4, c), 100.0, jnp.float32)
        theta = jnp.ones((model.theta_dim,), jnp.float32)
        if case == "sir_substep":
            return jax.make_jaxpr(
                lambda k, x: substep(model, k, x, theta, 0.05))(key, x)
        return jax.make_jaxpr(
            lambda k, x: advance(model, k, x, theta, 1.0, 20))(key, x)
    if case == "subgroup_advance":
        model = sir_subgroups_model(k=2)
        x = jnp.full((4, 6), 100.0, jnp.float32)
        theta = jnp.ones((5,), jnp.float32)
        return jax.make_jaxpr(
            lambda k, x: advance(model, k, x, theta, 1.0, 20))(key, x)
    if case == "ode_subgroup_rhs":
        from epitpu.ode import make_sir_subgroups_rhs

        rhs = make_sir_subgroups_rhs(2)
        return jax.make_jaxpr(rhs)(jnp.ones((6,)), jnp.ones((5,)))
    if case == "pmmh_proposal":
        from epitpu.mcmc import particle_mcmc_jit
        from epitpu.observe import get_observation_model

        y = jnp.ones((3, 3), jnp.float32)
        return jax.make_jaxpr(
            lambda k: particle_mcmc_jit(
                sir_model(), get_observation_model("binomial"), k, y,
                jnp.asarray([2.0, 1.0]), 0.05, n_iters=3, n_particles=8,
                steps_per_unit=2, n_init_attempts=2,
            ).thetas
        )(key)
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "sir_substep", "sir_advance", "seir_advance", "competing_advance",
    "subgroup_advance", "ode_subgroup_rhs", "pmmh_proposal",
])
def test_no_default_precision_dot(case):
    """No dot_general on these paths runs at default precision; the
    tau-leap paths hold no dot_general at all."""
    dots = _dot_generals(_jaxpr_of(case).jaxpr)
    if case.endswith(("_substep", "_advance")) and case != "subgroup_advance":
        assert dots == []
    for eqn in dots:
        assert eqn.params["precision"] == (HIGHEST, HIGHEST), (case, eqn)


def test_static_matmul_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**20, size=(5, 7, 4)).astype(np.float32)
    m = rng.integers(-2, 3, size=(4, 6))
    got = np.asarray(_static_matmul(jnp.asarray(a), m), np.float64)
    np.testing.assert_array_equal(got, a.astype(np.float64) @ m)


@pytest.mark.parametrize("sampler", ["fast", "fast_rbg"])
def test_advance_exact_at_population_1e6(sampler):
    """At population 10^6 every state stays an exact integer, each
    particle's population is conserved exactly, and a substep's update
    equals a float64 recomputation from the same event counts."""
    pop = 1_000_000.0
    model = sir_model()
    theta = jnp.asarray([2.0, 1.0], jnp.float32)
    x = jnp.broadcast_to(
        jnp.asarray([pop - 1000.0, 1000.0, 0.0], jnp.float32), (2, 64, 3)
    )
    key = jax.random.PRNGKey(3)
    max_count = 0.0
    for _ in range(4):
        key, k_sub, k_adv = jax.random.split(key, 3)
        n_ev = np.asarray(event_counts(model, k_sub, x, theta, 0.05, sampler),
                          np.float64)
        x_next = np.asarray(substep(model, k_sub, x, theta, 0.05, sampler))
        want = np.asarray(x, np.float64) + n_ev @ model.stoich
        np.testing.assert_array_equal(x_next.astype(np.float64), want)
        max_count = max(max_count, n_ev.max())
        x = advance(model, k_adv, x, theta, 1.0, 20, sampler)
        a = np.asarray(x)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.round(a))
        assert a.min() >= 0
        np.testing.assert_array_equal(a.astype(np.float64).sum(-1), pop)
    # the counts are far past 2^11, where TF32 would start rounding
    assert max_count > 2**11


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_location(tmp_path, env_dir):
    """enable_compilation_cache keeps JAX_COMPILATION_CACHE_DIR when it is
    set, and otherwise picks the fixed <repo>/.jax_cache."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "EPITPU_NO_COMPILATION_CACHE")}
    env["PYTHONPATH"] = REPO
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import epitpu, jax; epitpu.enable_compilation_cache(); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.strip().splitlines()[-1]
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert out == want
