"""Checks that only mean something on a GPU.  They skip elsewhere; run them
on the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
``chip_smoke.py`` makes the same checks at full size."""
import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend")


def test_tauleap_exact_on_gpu(gpu):
    chip_smoke.phase_tauleap(gpu, n_chains=8, n_particles=1024, units=6)


def test_filter_matches_cpu_on_gpu(gpu):
    chip_smoke.phase_filter_vs_cpu(gpu, jax.devices("cpu")[0], n_keys=32)
