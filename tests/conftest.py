"""Test configuration: an 8-device virtual CPU platform unless the caller
chose a platform.  These defaults are set before anything imports jax."""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

import epitpu

# cache setup is explicit (not an import side effect); the test suite is one
# of the entry points that wants it
epitpu.enable_compilation_cache()


@pytest.fixture(scope="session")
def sir_dataset():
    """Reference-style synthetic SIR dataset: ODE ground truth, binomial
    thinning p=0.1 (mirrors reference tests/test_under.py:25-33)."""
    import jax.numpy as jnp
    from epitpu.cli.configs import ExperimentConfig
    from epitpu.cli.run import generate_dataset

    y, latent = generate_dataset(ExperimentConfig())
    return jnp.asarray(y), latent
