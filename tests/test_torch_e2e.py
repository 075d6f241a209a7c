"""The port end to end on the CPU: EKF-SLAM, FastSLAM 1 and FastSLAM 2
through Runner on data/ring40 against the JAX package on the same map,
ticks and seeds; FastSLAM 2 with the heading unknown on its multi-tick
predict; the method dispatch and defaults of Runner, make_estimator and
the CLI against the JAX package's (EKF1 by default, any unknown name the
EKF); the CLI's report files; and a process that imports and runs the
port without ever importing JAX.

The ATE bound is statistical, not trace-identical: the two packages'
random streams differ (threefry vs torch's generator). The port's RMS
over three seeds must stay below twice the JAX package's."""

import os
import subprocess
import sys

import numpy as np
import pytest

from slam_tpu import config as jconfig
from slam_tpu import maps as jmaps
from slam_tpu_torch import config as tconfig
from slam_tpu_torch import maps as tmaps

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
DATA = os.path.join(ROOT, "data")
SEEDS = (3, 4, 5)
MARGIN = 2.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's runs here are small: on one thread they are faster,
    and do not compete with the JAX side's thread pool."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ring40():
    """data/ring40 read by each package's own config and map reader:
    {"jax": (config, map), "port": (config, map)}."""
    return {name: (config.SlamConfig.from_ini(os.path.join(DATA,
                                                            "ring40.ini")),
                   maps.read_map_file(os.path.join(DATA, "ring40.mat")))
            for name, config, maps in (("jax", jconfig, jmaps),
                                       ("port", tconfig, tmaps))}


def _rms_ate(runtime, cfg, slam_map, method="FASTSLAM1", n_ticks=400,
             **runner_kw):
    ates = []
    for seed in SEEDS:
        runner = runtime.Runner(cfg, slam_map, method, n_particles=32,
                                **runner_kw)
        result = runner.run(seed=seed, n_ticks=n_ticks)
        ate = runtime.compute_metrics(result).ate_rmse
        assert np.isfinite(ate)
        ates.append(ate)
    return float(np.sqrt(np.mean(np.square(ates)))), result


def test_fastslam1_ate_within_jax_bound(ring40):
    import slam_tpu.runtime as jrt
    import slam_tpu_torch.runtime as trt

    jax_ate, _ = _rms_ate(jrt, *ring40["jax"])
    cfg, slam_map = ring40["port"]
    port_ate, result = _rms_ate(trt, cfg, slam_map, device="cpu")
    assert port_ate < MARGIN * jax_ate, (port_ate, jax_ate)
    assert result.est_pose.shape == (400 // cfg.steps_per_observe, 3)
    assert int(result.final_state.n) > 0
    # K2 path: the resample gate, one sync a superstep (K2 writes the new
    # features with no host gate).
    assert result.host_syncs == len(result.active)


def test_fastslam2_ate_within_jax_bound(ring40):
    import slam_tpu.runtime as jrt
    import slam_tpu_torch.runtime as trt

    cfg, slam_map = ring40["port"]
    assert cfg.SWITCH_HEADING_KNOWN    # the per-tick predict and heading
    jax_ate, _ = _rms_ate(jrt, *ring40["jax"], "FASTSLAM2")
    port_ate, result = _rms_ate(trt, cfg, slam_map, "FASTSLAM2",
                                device="cpu")
    assert port_ate < MARGIN * jax_ate, (port_ate, jax_ate)
    assert result.est_pose.shape == (400 // cfg.steps_per_observe, 3)
    assert int(result.final_state.n) > 0
    # K2 path: FastSLAM 2 adds no sync to FastSLAM 1's one.
    assert result.host_syncs == len(result.active)


def test_ekf_ate_within_jax_bound(ring40):
    """EKF1 over 800 ticks (ring40's vehicle first sees a landmark at
    tick 296): no host sync at all, the state holds no particles."""
    import slam_tpu.runtime as jrt
    import slam_tpu_torch.runtime as trt

    jax_ate, _ = _rms_ate(jrt, *ring40["jax"], "EKF1", n_ticks=800)
    cfg, slam_map = ring40["port"]
    port_ate, result = _rms_ate(trt, cfg, slam_map, "EKF1", n_ticks=800,
                                device="cpu")
    assert port_ate < MARGIN * jax_ate, (port_ate, jax_ate)
    assert result.est_pose.shape == (800 // cfg.steps_per_observe, 3)
    assert int(result.final_state.n) > 0
    assert result.host_syncs == 0


def test_runner_defaults_to_ekf1_like_jax(ring40):
    """F5: the JAX Runner's default method is EKF1; so is the port's."""
    import inspect

    import slam_tpu.runtime as jrt
    from slam_tpu_torch.models import EkfSlam, EKFState
    from slam_tpu_torch.runtime import Runner

    jax_default = inspect.signature(jrt.Runner).parameters["method"].default
    port_default = inspect.signature(Runner).parameters["method"].default
    assert port_default == jax_default == "EKF1"
    cfg, slam_map = ring40["port"]
    runner = Runner(cfg, slam_map, device="cpu")
    assert runner.method == "EKF1" and type(runner.est) is EkfSlam
    result = runner.run(seed=3, n_ticks=2 * cfg.steps_per_observe)
    assert isinstance(result.final_state, EKFState)


def test_runner_positional_parameters_are_jax_s():
    """F7: the Runner's positional parameters begin as the JAX
    Runner's: config, slam_map, method, n_particles, estimator."""
    import inspect

    import slam_tpu.runtime as jrt
    from slam_tpu_torch.runtime import Runner

    jax_params = list(inspect.signature(jrt.Runner).parameters)
    port_params = list(inspect.signature(Runner).parameters)
    assert port_params[:5] == jax_params[:5] == [
        "config", "slam_map", "method", "n_particles", "estimator"]


def test_cli_help_lists_every_jax_option():
    """F7: every option the JAX CLI's -h text lists is in the port's,
    with its words (the backend-specific -profile and -ckpt lines
    aside), -mode included."""
    import slam_tpu.cli as jcli
    import slam_tpu_torch.cli as tcli

    def options(usage):
        return {line.split()[0]: line.strip() for line in usage.splitlines()
                if line.startswith("    -")}
    jax_opts, port_opts = options(jcli.USAGE), options(tcli.USAGE)
    assert set(jax_opts) <= set(port_opts), set(jax_opts) - set(port_opts)
    for flag in set(jax_opts) - {"-profile", "-ckpt", "-particles"}:
        assert port_opts[flag] == jax_opts[flag], flag
    assert port_opts["-mode"] == (
        "-mode <mode>     waypoints (interactive not supported headless)")


@pytest.mark.parametrize("method", ["EKF1", "EKF", "ekf1", "FOO", "",
                                    "FASTSLAM1", "fastslam2"])
def test_make_estimator_dispatches_as_jax(ring40, method):
    """F3: EKF and EKF1 are the EKF, and so is any name the dispatch
    does not know; the FastSLAM names are FastSLAM."""
    from slam_tpu.models import make_estimator as jax_make
    from slam_tpu_torch.models import make_estimator

    jcfg, slam_map = ring40["jax"]
    cfg, _ = ring40["port"]
    want = type(jax_make(method, jcfg, slam_map.n_landmarks)).__name__
    got = make_estimator(method, cfg, slam_map.n_landmarks, device="cpu")
    assert type(got).__name__ == want
    assert want == ("EkfSlam" if "FASTSLAM" not in method.upper()
                    else {"1": "FastSlam1", "2": "FastSlam2"}[method[-1]])


@pytest.mark.parametrize("args,estimator", [
    ([], "EkfSlam"),
    (["-method", "EKF"], "EkfSlam"),
    (["-method", "FOO"], "EkfSlam"),
    (["-method", "FASTSLAM1", "-particles", "8"], "FastSlam1"),
], ids=["default", "EKF", "FOO", "FASTSLAM1"])
def test_cli_method_like_jax(tmp_path, monkeypatch, capsys, args,
                             estimator):
    """F2: with no -method the CLI runs EKF1, as the JAX package's does;
    -method EKF and an unknown name run the EKF too."""
    import slam_tpu.cli as jcli
    import slam_tpu_torch.cli as tcli
    import slam_tpu_torch.runtime as rt

    assert "-method <name>   EKF1 | FASTSLAM1 | FASTSLAM2\n" in jcli.USAGE
    assert "-method <name>   EKF1 | FASTSLAM1 | FASTSLAM2\n" in tcli.USAGE
    built = []

    class Recording(rt.Runner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(type(self.est).__name__)
    monkeypatch.setattr(rt, "Runner", Recording)
    rc = tcli.main(["-m", os.path.join(DATA, "ring40.mat"), "-ticks", "80",
                    "-device", "cpu", "-n", "run", "-out", str(tmp_path),
                    *args])
    assert rc == 0 and built == [estimator]
    if not args:
        assert "slam_tpu_torch EKF1 on" in capsys.readouterr().err
    assert (tmp_path / "run" / "results.txt").exists()


def test_ekf_observes_the_noisy_heading(ring40, monkeypatch):
    """An EKF gets the simulator's noisy IMU heading every tick, truth +
    sigmaT * u with u that tick's uniform draw, as the JAX runner gives
    it; FastSLAM gets the true heading and the simulator draws nothing
    more for it. The expected headings are float32 numpy arithmetic on
    the ticks the simulator returned."""
    import torch

    from slam_tpu_torch.runtime import Runner
    from slam_tpu_torch.sim.simulator import Simulator

    cfg, slam_map = ring40["port"]
    control_ticks = Simulator.control_ticks
    drawn = []

    def recorded(self, state, n_ticks, imu=False):
        state, ticks = control_ticks(self, state, n_ticks, imu)
        drawn.append(ticks)
        return state, ticks
    monkeypatch.setattr(Simulator, "control_ticks", recorded)
    n_ticks = 3 * cfg.steps_per_observe
    for method in ("EKF1", "FASTSLAM1"):
        drawn.clear()
        seen = []
        runner = Runner(cfg, slam_map, method, n_particles=8, device="cpu")
        predict = runner.est.predict
        runner.est.predict = (lambda state, gen, v, g, phi, _p=predict:
                              seen.append(phi.item())
                              or _p(state, gen, v, g, phi))
        runner.run(seed=3, n_ticks=n_ticks)
        truth = torch.cat([t.poses for t in drawn])[:, 2].numpy()
        seen = np.asarray(seen, np.float32)
        assert len(seen) == len(truth) == n_ticks
        if method == "EKF1":
            u = torch.cat([t.imu_draws for t in drawn]).numpy()
            assert ((u >= 0) & (u < 1)).all() and u.std() > 0
            assert np.array_equal(seen, truth + np.float32(cfg.sigmaT) * u)
        else:
            assert all(t.imu_draws is None for t in drawn)
            assert np.array_equal(seen, truth)


def test_fastslam2_heading_unknown_takes_the_multi_tick_predict(
        monkeypatch):
    """At P = 1024 with the heading unknown the runner predicts each
    superstep in one predict_multi call (K6b's twin on the CPU) and
    never per tick; the update takes K4 (one sync per superstep)."""
    from slam_tpu_torch.models import FastSlam2
    from slam_tpu_torch.ops.kernels import predict as tp
    from slam_tpu_torch.runtime import Runner, compute_metrics

    calls = {"per_tick": 0, "multi": 0}
    for name, key in (("predict", "per_tick"), ("_predict_multi", "multi")):
        fn = getattr(FastSlam2, name)

        def counted(self, *a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(self, *a)
        monkeypatch.setattr(FastSlam2, name, counted)
    twin = tp.fs2_predict_multi_plain
    twin_calls = []
    monkeypatch.setattr(tp, "fs2_predict_multi_plain",
                        lambda *a, **k: twin_calls.append(1) or twin(*a, **k))

    cfg = tconfig.SlamConfig(SWITCH_HEADING_KNOWN=0)
    slam_map = tmaps.synthetic_map(35, 17, radius=100.0)
    result = Runner(cfg, slam_map, "FASTSLAM2", n_particles=1024,
                    device="cpu").run(
        seed=3, n_ticks=6 * cfg.steps_per_observe)
    assert calls == {"per_tick": 0, "multi": 6} and len(twin_calls) == 6
    assert result.host_syncs == 6
    assert np.isfinite(compute_metrics(result).ate_rmse)
    assert np.isfinite(result.est_pose).all()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("method", ["FASTSLAM1", "FASTSLAM2"])
def test_cli_writes_report(tmp_path, method):
    proc = subprocess.run(
        [sys.executable, "-m", "slam_tpu_torch", "-m",
         os.path.join(DATA, "ring40.mat"), "-method", method,
         "-particles", "16", "-ticks", "160", "-seed", "3", "-device",
         "cpu", "-n", "run", "-out", str(tmp_path)],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"slam_tpu_torch {method} on" in proc.stderr
    out = tmp_path / "run"
    for f in ("results.txt", "errors.txt", "times.txt", "positions.txt",
              "observedCounts.txt", "averageLengthLandmark.txt"):
        assert (out / f).exists(), f
    assert "ATE RMSE" in (out / "results.txt").read_text()
    assert np.loadtxt(out / "errors.txt").shape[0] == np.loadtxt(
        out / "positions.txt", delimiter=",").shape[0]


def test_cli_warns_on_an_unsupported_mode_and_runs(tmp_path):
    """-mode other than waypoints: a warning on stderr and the waypoint
    run, as the JAX package's CLI does."""
    proc = subprocess.run(
        [sys.executable, "-m", "slam_tpu_torch", "-m",
         os.path.join(DATA, "ring40.mat"), "-mode", "foo", "-particles",
         "8", "-ticks", "40", "-device", "cpu", "-n", "run", "-out",
         str(tmp_path)],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "warning: mode 'foo' not supported; using waypoints" in proc.stderr
    assert (tmp_path / "run" / "results.txt").exists()


def test_port_never_imports_jax(tmp_path):
    code = (
        "import sys\n"
        "import slam_tpu_torch\n"
        "assert 'jax' not in sys.modules, 'import slam_tpu_torch'\n"
        "from slam_tpu_torch.cli import main\n"
        "for method in ('EKF1', 'FASTSLAM1', 'FASTSLAM2'):\n"
        f"    rc = main(['-m', {os.path.join(DATA, 'ring40.mat')!r}, "
        "'-method', method, '-particles', '8', '-ticks', '80', "
        f"'-device', 'cpu', '-out', {str(tmp_path)!r}])\n"
        "    assert rc == 0, method\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib')], 'a CPU run'\n"
        "print('no jax')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout


# --- the run options: -ckpt, -plot, -profile -------------------------------

def _cli(tmp_path, *args):
    import slam_tpu_torch.cli as tcli
    return tcli.main(["-m", os.path.join(DATA, "ring40.mat"), "-device",
                      "cpu", "-n", "run", "-out", str(tmp_path), *args])


def test_cli_ckpt_resumes_on_the_second_call(tmp_path):
    """-ckpt runs in chunks of 50 supersteps (400 ticks); a second call
    with twice the ticks resumes from the first one's checkpoint and
    reports only the supersteps it ran."""
    import json

    ck = str(tmp_path / "ck" / "run")
    args = ("-method", "FASTSLAM1", "-particles", "8", "-seed", "3",
            "-ckpt", ck)
    assert _cli(tmp_path, "-ticks", "400", *args) == 0
    with open(ck + ".json") as fh:
        assert json.load(fh)["superstep"] == 50
    assert np.loadtxt(tmp_path / "run" / "errors.txt").shape[0] == 50
    assert _cli(tmp_path, "-ticks", "800", *args) == 0
    with open(ck + ".json") as fh:
        manifest = json.load(fh)
    assert manifest["superstep"] == 100
    assert manifest["meta"] == {"method": "FASTSLAM1", "seed": 3}
    assert np.loadtxt(tmp_path / "run" / "errors.txt").shape[0] == 50


@pytest.mark.parametrize("publisher", ["native", "python"])
def test_cli_plot_streams_to_the_publisher(tmp_path, monkeypatch,
                                           publisher):
    """-plot takes the native publisher when it loads, else the Python
    one (the order of the JAX CLI); both are replaced by capture
    sockets here. The messages pass the GUI's dispatch checks, one turn
    per superstep."""
    import test_golden_frames as golden
    import test_telemetry

    import slam_tpu_torch.runtime.native as native
    import slam_tpu_torch.runtime.telemetry as telemetry

    sock = golden._CaptureSocket()
    capture = telemetry.NetworkPlot(socket=sock)
    if publisher == "native":
        monkeypatch.setattr(native, "NativeNetworkPlot", lambda: capture)
    else:
        def unavailable():
            raise OSError("libslam_native.so unavailable")
        monkeypatch.setattr(native, "NativeNetworkPlot", unavailable)
        monkeypatch.setattr(telemetry, "NetworkPlot", lambda: capture)
    assert _cli(tmp_path, "-plot", "-method", "FASTSLAM1", "-particles",
                "8", "-ticks", "80") == 0
    ctrl = test_telemetry.StrictController()
    for frames in sock.sent:
        ctrl.feed(frames)
    assert ctrl.done and ctrl.n_turns == 10
    assert ("setSimulationName", [b"run"]) in [
        (m[0].decode(), m[1:]) for m in sock.sent]


def test_cli_plot_does_not_swallow_the_next_flag(tmp_path, monkeypatch):
    """-plot takes no value: the flag after it keeps its own (here
    -method FASTSLAM1, not the EKF default), as in the JAX CLI."""
    import test_golden_frames as golden

    import slam_tpu_torch.runtime as rt
    import slam_tpu_torch.runtime.native as native
    import slam_tpu_torch.runtime.telemetry as telemetry

    sock = golden._CaptureSocket()
    monkeypatch.setattr(native, "NativeNetworkPlot",
                        lambda: telemetry.NetworkPlot(socket=sock))
    built = []

    class Recording(rt.Runner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append((type(self.est).__name__, self.n_particles))
    monkeypatch.setattr(rt, "Runner", Recording)
    assert _cli(tmp_path, "-plot", "-method", "FASTSLAM1", "-plot",
                "-particles", "8", "-ticks", "16") == 0
    assert built == [("FastSlam1", 8)]
    assert [m[0] for m in sock.sent].count(b"plot") == 2


def test_cli_profile_writes_a_trace(tmp_path):
    """-profile DIR: a torch.profiler trace of the run, in the Chrome
    trace format, with the run's operators in it, beside the run's spans
    (spans.json, test_torch_spans.py)."""
    import json

    assert _cli(tmp_path, "-method", "FASTSLAM1", "-particles", "8",
                "-ticks", "16", "-profile", str(tmp_path / "prof")) == 0
    files = [f for f in os.listdir(tmp_path / "prof") if f != "spans.json"]
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert (tmp_path / "prof" / "spans.json").exists()
    with open(tmp_path / "prof" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert (tmp_path / "run" / "results.txt").exists()


@pytest.mark.parametrize("method", ["FASTSLAM1", "EKF1"])
def test_time_phases_has_the_jax_keys(ring40, method):
    """time_phases on the CPU: JAX's keys, positive medians, and the
    runner's state untouched by the timed calls (each gets a copy)."""
    import inspect

    from slam_tpu.runtime import profiling as jprof
    from slam_tpu_torch.runtime import Runner
    from slam_tpu_torch.runtime import profiling as tprof

    assert (list(inspect.signature(tprof.time_phases).parameters)
            == list(inspect.signature(jprof.time_phases).parameters))
    cfg, slam_map = ring40["port"]
    runner = Runner(cfg, slam_map, method, n_particles=8, device="cpu")
    phases = tprof.time_phases(runner, seed=3, iters=3)
    assert set(phases) == {"predict_tick_s", "observe_update_s",
                           "superstep_s", "steps_per_observe"}
    assert phases["steps_per_observe"] == cfg.steps_per_observe
    assert all(phases[k] > 0 for k in ("predict_tick_s", "observe_update_s",
                                       "superstep_s"))
