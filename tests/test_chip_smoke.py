"""Rehearsal of chip_smoke.py on the CPU.

The script's own entry point refuses any backend but a GPU.  Its phase
functions take the device to run on, so each one runs here at a tiny size
on a CPU device: that catches wrong paths, arguments and control flow
before a GPU run.  What only the GPU can show is left to the script.
"""
import jax
import pytest

import chip_smoke
from epitpu.cli.run import PRESETS


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def clock():
    return chip_smoke.CompileClock()


def test_main_refuses_cpu_backend(tmp_path, capsys):
    assert chip_smoke.main(["--out", str(tmp_path)]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_tauleap(cpu):
    info = chip_smoke.phase_tauleap(
        cpu, n_chains=2, n_particles=32, units=4, steps_per_unit=10)
    assert info["max_event_count"] > 2**11


def test_phase_sampler_law(cpu):
    info = chip_smoke.phase_sampler_law(cpu, n_draws=1 << 16)
    assert info["worst_mean_z"] < 4.0


def test_phase_filter_vs_cpu(cpu):
    info = chip_smoke.phase_filter_vs_cpu(
        cpu, cpu, n_particles=64, n_keys=8, steps_per_unit=5,
        resample_n=512, resample_rows=4)
    # the same device on both sides: the same keys give the same numbers
    assert info["ll_gap"] == 0.0
    assert info["resample_mismatches"] == 0


def test_phase_pmmh(cpu, clock, tmp_path):
    cfg = PRESETS["production"]()
    cfg.mcmc.n_chains, cfg.mcmc.n_iters = 8, 200
    cfg.mcmc.steps_per_unit = 5
    info = chip_smoke.phase_pmmh(
        cpu, str(tmp_path), clock, cfg=cfg, bench_shape=(2, 32, 8))
    assert info["rhat"] < 1.1


def test_phase_batch_paths(cpu, clock, tmp_path):
    abc_cfg = PRESETS["sir_abc"]()
    abc_cfg.abc.n_samples, abc_cfg.abc.steps_per_unit = 4, 5
    fc_cfg = PRESETS["sir_underreported"]()
    fc_cfg.mcmc.n_iters, fc_cfg.mcmc.n_particles = 60, 32
    fc_cfg.mcmc.steps_per_unit = 5
    info = chip_smoke.phase_batch_paths(
        cpu, str(tmp_path), clock, abc_cfg=abc_cfg, fc_cfg=fc_cfg,
        abc_batch=128, abc_trials=1024, fc_draws=256)
    assert info["candidates_per_s"] > 0
    assert info["forecast_draws_per_s"] > 0


def test_phase_multi_on_virtual_devices():
    """The --multi path on 4 virtual CPU devices at a tiny size."""
    chip_smoke.phase_multi(
        jax.devices("cpu"), n_devices=4, pmmh_iters=20, prod_chains=8,
        mesh_particles=64, filter_seeds=4)
