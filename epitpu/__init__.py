"""epitpu — accelerator-native Bayesian inference for stochastic epidemic
models.

A ground-up JAX/XLA redesign with the capabilities of
GeorgeEfstathiadis/Stochastic-Epidemic-Modelling: forward simulation
(exact SSA + tau-leap), ABC rejection, bootstrap particle filtering,
ancestral path sampling, PMMH with adaptive proposals, diagnostics, and a
config-driven experiment runner — vectorized over particles, vmapped over
chains, and sharded over device meshes.
"""

__version__ = "0.1.0"


def enable_compilation_cache():
    """Point JAX at a persistent on-disk compilation cache.

    Without one, every process recompiles the full PMMH program, which
    takes minutes on a small host.  When ``JAX_COMPILATION_CACHE_DIR`` (or
    the ``jax_compilation_cache_dir`` config) is set, that directory is
    used and nothing else is set here; otherwise the cache is the fixed,
    git-ignored ``<repo>/.jax_cache``.  The path is part of the cache key,
    so it must not move between runs.

    Called explicitly by epitpu's own entry points (the CLI runner, bench
    scripts, tests) — NOT at import time, so embedders sharing a process
    with other JAX users see no global-config side effect from merely
    importing the package.  Opt out with EPITPU_NO_COMPILATION_CACHE=1.
    """
    import os

    if os.environ.get("EPITPU_NO_COMPILATION_CACHE"):
        return
    try:
        import jax

        if jax.config.jax_compilation_cache_dir is None:
            jax.config.update(
                "jax_compilation_cache_dir",
                os.path.join(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))), ".jax_cache"),
            )
            jax.config.update(
                "jax_persistent_cache_min_compile_time_secs", 1.0
            )
    except Exception:  # pragma: no cover - cache is best-effort
        pass


from . import models, sim, ode, observe, smc, mcmc  # noqa: F401,E402
