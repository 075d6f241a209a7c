"""The port end to end on the CPU: FastSLAM 1 through Runner on
data/ring40 against the JAX package on the same map, ticks and seeds;
the CLI's report files; and a process that imports and runs the port
without ever importing JAX.

The ATE bound is statistical, not trace-identical: the two packages'
random streams differ (threefry vs torch's generator). The port's RMS
over three seeds must stay below twice the JAX package's."""

import os
import subprocess
import sys

import numpy as np
import pytest

from slam_tpu.config import SlamConfig
from slam_tpu.maps import read_map_file

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
DATA = os.path.join(ROOT, "data")
SEEDS = (3, 4, 5)
MARGIN = 2.0


@pytest.fixture(scope="module")
def ring40():
    cfg = SlamConfig.from_ini(os.path.join(DATA, "ring40.ini"))
    return cfg, read_map_file(os.path.join(DATA, "ring40.mat"))


def _rms_ate(runtime, cfg, slam_map):
    ates = []
    for seed in SEEDS:
        runner = runtime.Runner(cfg, slam_map, "FASTSLAM1", n_particles=32)
        result = runner.run(seed=seed, n_ticks=400)
        ate = runtime.compute_metrics(result).ate_rmse
        assert np.isfinite(ate)
        ates.append(ate)
    return float(np.sqrt(np.mean(np.square(ates)))), result


def test_fastslam1_ate_within_jax_bound(ring40):
    import slam_tpu.runtime as jrt
    import slam_tpu_torch.runtime as trt

    cfg, slam_map = ring40
    jax_ate, _ = _rms_ate(jrt, cfg, slam_map)
    port_ate, result = _rms_ate(trt, cfg, slam_map)
    assert port_ate < MARGIN * jax_ate, (port_ate, jax_ate)
    assert result.est_pose.shape == (400 // cfg.steps_per_observe, 3)
    assert int(result.final_state.n) > 0
    # K2 path: the new-feature gate and the resample gate, one sync each.
    assert result.host_syncs == 2 * len(result.active)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_writes_report(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "slam_tpu_torch", "-m",
         os.path.join(DATA, "ring40.mat"), "-method", "FASTSLAM1",
         "-particles", "16", "-ticks", "160", "-seed", "3", "-device",
         "cpu", "-n", "run", "-out", str(tmp_path)],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = tmp_path / "run"
    for f in ("results.txt", "errors.txt", "times.txt", "positions.txt",
              "observedCounts.txt", "averageLengthLandmark.txt"):
        assert (out / f).exists(), f
    assert "ATE RMSE" in (out / "results.txt").read_text()
    assert np.loadtxt(out / "errors.txt").shape[0] == np.loadtxt(
        out / "positions.txt", delimiter=",").shape[0]


def test_port_never_imports_jax(tmp_path):
    code = (
        "import sys\n"
        "import slam_tpu_torch\n"
        "assert 'jax' not in sys.modules, 'import slam_tpu_torch'\n"
        "from slam_tpu_torch.cli import main\n"
        f"rc = main(['-m', {os.path.join(DATA, 'ring40.mat')!r}, "
        "'-particles', '8', '-ticks', '80', '-device', 'cpu', "
        f"'-out', {str(tmp_path)!r}])\n"
        "assert rc == 0\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib')], 'a CPU run'\n"
        "print('no jax')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout


def test_unported_method_names_the_roadmap():
    from slam_tpu_torch.models import make_estimator

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_estimator("FASTSLAM2", SlamConfig(), 10)
