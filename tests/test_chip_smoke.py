"""chip_smoke.py and bench.py refuse to run without a GPU; on-card parity
tests (marker ``gpu``) of the flagship paths."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_fail_without_a_gpu(script):
    """On the CPU both exit non-zero before any phase and print no number
    (a measurement path never falls back to the CPU)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, os.path.join(ROOT, script)], env=env,
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode != 0
    assert "needs" in r.stderr and "GPU" in r.stderr, r.stderr[-2000:]
    assert r.stdout.strip() == "", r.stdout


def test_chip_smoke_device_check_in_process(capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--four"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "GPU" in out.err


@pytest.mark.gpu
def test_flagship_tick_matches_oracle_on_gpu(gpu):
    """Engine.replan_refresh at the flagship widths on the card: the first
    tick's controls for 8 clear scenarios match tests/oracle.py."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    ph = chip_smoke.Phases()
    chip_smoke.phase_replan_refresh(ph, S=1024, n=3)
    assert jax.devices()[0] == gpu and "replan_refresh" in ph.setup_s


@pytest.mark.gpu
def test_mi_tick_matches_per_scenario_path_on_gpu(gpu):
    """The MI tick's dense refresh on the card (TF32 pins) stays within the
    1e-3 budget of the per-scenario HIGHEST path."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke.phase_replan_refresh_mi(chip_smoke.Phases(), S=1024, n=3)
    assert np.isfinite(gpu.memory_stats()["bytes_in_use"])
