"""The port's checkpoints (slam_tpu_torch.runtime.checkpoint), its
checkpointed run and its crash recovery against the JAX package's, on
the CPU, on data/ring40.

- A save and load round trip is bit-exact: every tensor, the host
  values (a pending resample), tick, and both generators (their next
  draws agree).
- A resumed run equals the unbroken run bit for bit: FastSLAM 1 at
  P = 64, EKF1, and FastSlam1Deferred at P = 1024 with the resume at a
  superstep where a resample is pending.
- The JAX package's chunk semantics: at 25 supersteps in chunks of 10
  the checkpoint is at superstep 30 and the traces hold 25 rows, in
  both packages; a resume to 40 returns 10 rows in both; a resume from
  the finished checkpoint raises ValueError in both.
- A checkpoint loads only on the device type that wrote it.
- ``load_jax_checkpoint``: the planes of a JAX FastSLAM 1 checkpoint
  written mid-run, and of a JAX deferred carry and EKF state, arrive
  bit for bit; a mid-run JAX EKF1 checkpoint (control and sensor noise
  off, heading unknown, so neither run draws a random number) continued
  for 10 supersteps in both packages: n and da_table exact, the poses
  within rtol/atol 1e-4.
- ``save_jax_checkpoint`` (F8): a port checkpoint of FS1 (P = 16) and
  of EKF1, cut at superstep 20 of ring40 with the control and sensor
  noise off, rewritten in the JAX layout, resumes in the JAX package's
  ``Runner.run_checkpointed(resume=True)``: the truth continues the
  port's unbroken run within 1e-4; EKF1, which then draws no random
  number, also its estimate (rtol/atol 1e-4), n and da_table (exact).
  The keys are JAX's ``PRNGKey(seed)`` and ``PRNGKey(seed + 1)``.
- ``run_resilient`` with a failure injected after the first chunk ends
  where the clean run ends (the pattern of tests/test_resilience.py).
- A sharded run (2 gloo ranks, ``torch_parallel_workers.
  checkpoint_world``): ``ShardedFastSlam1`` (ring40, P = 64, where each
  rank draws its predict noise and resample dither from its own stream)
  and ``ShardedEkfSlam`` on a 2-rank landmark mesh, cut at superstep 40
  and resumed to 60, equal the unbroken runs bit for bit; each writes
  one checkpoint for both ranks; a resume on a mesh of another shape,
  or on none, raises ValueError naming both.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import config as jconfig
from slam_tpu import maps as jmaps
from slam_tpu.models import fastslam1 as jfs1
from slam_tpu.runtime import Runner as JRunner
from slam_tpu.runtime.checkpoint import save_checkpoint as jax_save
from slam_tpu_torch import config as tconfig
from slam_tpu_torch import maps as tmaps
from slam_tpu_torch.models import FastSlam1Deferred
from slam_tpu_torch.runtime import Runner, load_checkpoint, save_checkpoint
from slam_tpu_torch.runtime.checkpoint import (
    load_jax_checkpoint,
    save_jax_checkpoint,
)
from slam_tpu_torch.runtime.resilience import run_resilient

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
NOISE_OFF = dict(SWITCH_CONTROL_NOISE=0, SWITCH_SENSOR_NOISE=0,
                 SWITCH_HEADING_KNOWN=0)
# FastSlam1Deferred at P = 1024, seed 3: a resample is pending after
# superstep 48 (the vehicle first sees a landmark at superstep 37).
PENDING_AT = 48


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's tensors here are small: one thread is faster, and does
    not compete with the JAX side's thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**overrides):
    """data/ring40 read by each package: (JAX config, JAX map, port
    config, port map)."""
    ini, mat = (os.path.join(DATA, f"ring40.{e}") for e in ("ini", "mat"))
    ov = {k: str(v) for k, v in overrides.items()}
    return (jconfig.SlamConfig.from_ini(ini, overrides=ov),
            jmaps.read_map_file(mat),
            tconfig.SlamConfig.from_ini(ini, overrides=ov),
            tmaps.read_map_file(mat))


def port_runner(kind, cfg, slam_map):
    if kind == "deferred":
        est = FastSlam1Deferred(cfg, slam_map.n_landmarks, device="cpu")
        return Runner(cfg, slam_map, "FASTSLAM1", n_particles=1024,
                      estimator=est)
    return Runner(cfg, slam_map, kind, n_particles=64, device="cpu")


def tensors(tree):
    """The tensors of a state, depth first."""
    for v in tree:
        if isinstance(v, tuple):
            yield from tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v


def assert_states_equal(a, b):
    ta, tb = list(tensors(a)), list(tensors(b))
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert ([v for v in a if not isinstance(v, (tuple, torch.Tensor))]
            == [v for v in b if not isinstance(v, (tuple, torch.Tensor))])


def assert_results_equal(full, tail):
    n = len(tail.est_pose)
    for f in ("true_pose", "est_pose", "active", "obs_count", "obs_z",
              "obs_mask", "obs_ids", "odom"):
        np.testing.assert_array_equal(getattr(full, f)[-n:],
                                      getattr(tail, f), err_msg=f)
    assert_states_equal(full.final_state, tail.final_state)


@pytest.mark.parametrize("kind", ["FASTSLAM1", "EKF1", "deferred"])
def test_save_load_round_trip_is_bit_exact(tmp_path, kind):
    *_, cfg, slam_map = configs()
    runner = port_runner(kind, cfg, slam_map)
    sim, est, gen, _ = runner._init(3)
    step = runner._superstep_for(est)
    for _ in range(PENDING_AT):
        sim, est, _ = runner._step(step, sim, est, gen)
    if kind == "deferred":
        assert est.pending
    path = str(tmp_path / "ck")
    save_checkpoint(path, sim, est, gen, superstep=PENDING_AT,
                    meta={"x": 1})
    manifest = json.loads((tmp_path / "ck.json").read_text())
    assert manifest["meta"] == {"x": 1} and manifest["device_type"] == "cpu"
    sim2, est2, gen2, at = load_checkpoint(path, runner.sim.init(),
                                           runner.est.init(runner.n_particles),
                                           device="cpu")
    assert at == PENDING_AT and sim2.tick == sim.tick
    assert_states_equal(est, est2)
    assert_states_equal(sim.vehicle, sim2.vehicle)
    for g, g2 in ((gen, gen2), (sim.generator, sim2.generator)):
        assert torch.equal(g.get_state(), g2.get_state())
        assert torch.equal(torch.randn(5, generator=g),
                           torch.randn(5, generator=g2))


@pytest.mark.parametrize("kind,n,every,cut", [
    ("FASTSLAM1", 50, 10, 20),
    ("EKF1", 50, 10, 40),
    ("deferred", 56, 8, PENDING_AT),
])
def test_resume_is_bit_exact(tmp_path, kind, n, every, cut):
    """An unbroken checkpointed run against one cut at superstep
    ``cut`` and resumed: the tail and the final state bit for bit."""
    *_, cfg, slam_map = configs()
    period = cfg.steps_per_observe
    full = port_runner(kind, cfg, slam_map).run_checkpointed(
        seed=3, n_ticks=n * period, every=every,
        ckpt_path=str(tmp_path / "a"))
    ck = str(tmp_path / "b")
    port_runner(kind, cfg, slam_map).run_checkpointed(
        seed=3, n_ticks=cut * period, every=every, ckpt_path=ck)
    manifest = json.loads((tmp_path / "b.json").read_text())
    assert manifest["superstep"] == cut
    if kind == "deferred":
        assert manifest["est_host"] == [True]     # pending at the cut
    resumed = port_runner(kind, cfg, slam_map).run_checkpointed(
        seed=3, n_ticks=n * period, every=every, ckpt_path=ck, resume=True)
    assert len(resumed.est_pose) == n - cut
    assert resumed.n_ticks == (n - cut) * period
    assert_results_equal(full, resumed)


@pytest.fixture(scope="module")
def overshoot(tmp_path_factory):
    """25 supersteps in chunks of 10 in each package (FASTSLAM1,
    P = 16), then a resume to 40: {package: (first, manifest, resumed,
    checkpoint path)}."""
    jcfg, jmap, cfg, slam_map = configs()
    period = cfg.steps_per_observe
    out = {}
    for name, make in (
            ("jax", lambda: JRunner(jcfg, jmap, "FASTSLAM1", n_particles=16)),
            ("port", lambda: Runner(cfg, slam_map, "FASTSLAM1",
                                    n_particles=16, device="cpu"))):
        ck = str(tmp_path_factory.mktemp(name) / "run")
        first = make().run_checkpointed(seed=4, n_ticks=25 * period,
                                        every=10, ckpt_path=ck)
        with open(ck + ".json") as fh:
            manifest = json.load(fh)
        resumed = make().run_checkpointed(seed=4, n_ticks=40 * period,
                                          every=10, ckpt_path=ck,
                                          resume=True)
        out[name] = (first, manifest, resumed, ck, make)
    return out


def test_overshoot_matches_jax(overshoot):
    (jfirst, jman, jres, *_), (tfirst, tman, tres, *_) = (
        overshoot["jax"], overshoot["port"])
    assert tman["superstep"] == jman["superstep"] == 30
    for f in ("n_sim_leaves", "n_est_leaves", "meta"):
        assert tman[f] == jman[f], f
    for f in ("true_pose", "est_pose", "active", "obs_z", "odom"):
        assert getattr(tfirst, f).shape == getattr(jfirst, f).shape, f
        assert getattr(tres, f).shape == getattr(jres, f).shape, f
    assert len(tfirst.est_pose) == 25 and len(tres.est_pose) == 10
    assert tfirst.n_ticks == jfirst.n_ticks
    assert tres.n_ticks == jres.n_ticks


def test_resume_from_a_finished_checkpoint_raises_as_jax(overshoot):
    """The checkpoints stand at superstep 40 after the resume; a run of
    25 supersteps has nothing left to do. The JAX package raises
    ValueError (an empty np.concatenate); so does the port, naming the
    checkpoint."""
    period = tconfig.SlamConfig.from_ini(
        os.path.join(DATA, "ring40.ini")).steps_per_observe
    for name in ("jax", "port"):
        *_, ck, make = overshoot[name]
        with pytest.raises(ValueError) as err:
            make().run_checkpointed(seed=4, n_ticks=25 * period, every=10,
                                    ckpt_path=ck, resume=True)
        if name == "port":
            assert ck in str(err.value) and "finished" in str(err.value)


def test_load_into_another_shape_raises(tmp_path):
    """A checkpoint of P = 64 does not load into a run of P = 32."""
    *_, cfg, slam_map = configs()
    runner = port_runner("FASTSLAM1", cfg, slam_map)
    sim, est, gen, _ = runner._init(3)
    path = str(tmp_path / "ck")
    save_checkpoint(path, sim, est, gen, superstep=0)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, sim, runner.est.init(32), device="cpu")


def test_load_on_another_device_type_raises(tmp_path):
    *_, cfg, slam_map = configs()
    runner = port_runner("FASTSLAM1", cfg, slam_map)
    sim, est, gen, _ = runner._init(3)
    path = str(tmp_path / "ck")
    save_checkpoint(path, sim, est, gen, superstep=0)
    with pytest.raises(ValueError, match="cpu device"):
        load_checkpoint(path, sim, est, device="cuda")
    manifest = json.loads((tmp_path / "ck.json").read_text())
    manifest["device_type"] = "cuda"
    (tmp_path / "ck.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="cuda device"):
        load_checkpoint(path, sim, est, device="cpu")


def test_load_jax_checkpoint_carries_fastslam1_planes(overshoot):
    """The JAX FASTSLAM1 checkpoint written mid-run (superstep 30 of the
    fixture's first run; the resume rewrote it at 40): every plane, n and
    da_table, the vehicle and tick bit for bit; fresh generators."""
    *_, ck, _ = overshoot["jax"]
    *_, cfg, slam_map = configs()
    runner = port_runner("FASTSLAM1", cfg, slam_map)
    sim, est, gen, at = load_jax_checkpoint(
        ck, runner.sim.init(), runner.est.init(16), seed=4, device="cpu")
    with np.load(ck + ".npz") as data:
        saved = {k: data[k] for k in data.files}
    assert at == 40
    for i, t in enumerate(est):
        assert t.dtype == torch.from_numpy(saved[f"est_{i}"]).dtype
        np.testing.assert_array_equal(t.numpy(), saved[f"est_{i}"])
    for i, t in enumerate(sim.vehicle):
        np.testing.assert_array_equal(t.numpy(), saved[f"sim_{i}"])
    assert sim.tick == int(saved["sim_6"]) == 40 * cfg.steps_per_observe
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(5).get_state())


@pytest.mark.parametrize("kind", ["deferred", "EKF1"])
def test_load_jax_checkpoint_carries_state(tmp_path, kind):
    """A JAX deferred carry (whose window metadata lo, nch, ident the
    port drops) and a JAX EKF state, written by the JAX package's
    save_checkpoint from seeded arrays, arrive bit for bit."""
    jcfg, jmap, cfg, slam_map = configs()
    rng = np.random.default_rng(5)
    jrunner = JRunner(jcfg, jmap, "EKF1" if kind == "EKF1" else "FASTSLAM1")
    if kind == "deferred":
        jest = jfs1.FastSlam1Deferred(jcfg, jmap.n_landmarks,
                                      interpret=True, fused_predict=False)
        js = jest.init(1024)
        ps = js.ps._replace(**{
            f: jnp.asarray(rng.normal(size=getattr(js.ps, f).shape)
                           .astype(np.float32))
            for f in ("logw", "xv", "Pv", "lm", "lm_P")})
        S = np.sort(rng.integers(0, 1025, 1024)).astype(np.int32)
        js = js._replace(ps=ps, S=jnp.asarray(S))
        want = [*jax.tree_util.tree_leaves(js.ps), js.S]
    else:
        js = jrunner.est.init()
        js = js._replace(x=jnp.asarray(rng.normal(size=js.x.shape)
                                       .astype(np.float32)),
                         P=jnp.asarray(rng.normal(size=js.P.shape)
                                       .astype(np.float32)))
        want = jax.tree_util.tree_leaves(js)
    path = str(tmp_path / "ck")
    jax_save(path, jrunner.sim.init(seed=3), js, jax.random.PRNGKey(4),
             superstep=12)
    runner = port_runner(kind, cfg, slam_map)
    _, est, _, at = load_jax_checkpoint(path, runner.sim.init(),
                                        runner.est.init(1024), seed=3,
                                        device="cpu")
    assert at == 12
    got = list(tensors(est))
    assert len(got) == len(want)
    for t, w in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    if kind == "deferred":
        assert est.pending


def test_load_jax_checkpoint_continues_like_jax(tmp_path):
    """EKF1 with the noise off: JAX runs 50 supersteps and checkpoints;
    the port loads that checkpoint, saves it as its own and resumes to
    superstep 60, as the JAX package resumes its own."""
    jcfg, jmap, cfg, slam_map = configs(**NOISE_OFF)
    period = cfg.steps_per_observe
    jck, jck50 = str(tmp_path / "jax"), str(tmp_path / "jax50")
    JRunner(jcfg, jmap, "EKF1").run_checkpointed(
        seed=3, n_ticks=50 * period, every=50, ckpt_path=jck)
    for ext in (".npz", ".json"):     # the resume below rewrites jck
        shutil.copy(jck + ext, jck50 + ext)
    jres = JRunner(jcfg, jmap, "EKF1").run_checkpointed(
        seed=3, n_ticks=60 * period, every=10, ckpt_path=jck, resume=True)

    runner = Runner(cfg, slam_map, "EKF1", device="cpu")
    sim, est, gen, at = load_jax_checkpoint(
        jck50, runner.sim.init(), runner.est.init(), seed=3, device="cpu")
    assert at == 50 and int(est.n) > 0
    tck = str(tmp_path / "port")
    save_checkpoint(tck, sim, est, gen, at)
    tres = runner.run_checkpointed(seed=3, n_ticks=60 * period, every=10,
                                   ckpt_path=tck, resume=True)
    assert len(tres.est_pose) == len(jres.est_pose) == 10
    np.testing.assert_allclose(tres.true_pose, jres.true_pose, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tres.est_pose, jres.est_pose, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tres.obs_ids, jres.obs_ids)
    assert int(tres.final_state.n) == int(jres.final_state.n)
    np.testing.assert_array_equal(tres.final_state.da_table.numpy(),
                                  np.asarray(jres.final_state.da_table))


class FlakyRunner(Runner):
    """Fails in its first run_checkpointed call, after the first chunk
    is saved (tests/test_resilience.py's FlakyRunner)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.crashes_left = 1

    def run_checkpointed(self, **kw):
        if self.crashes_left and not kw.get("resume"):
            self.crashes_left -= 1
            try:
                super().run_checkpointed(**{
                    **kw, "n_ticks": 10 * self.config.steps_per_observe})
            finally:
                raise RuntimeError("injected failure")
        return super().run_checkpointed(**kw)


def test_run_resilient_recovers(tmp_path, capsys):
    *_, cfg, slam_map = configs()
    n_ticks = 30 * cfg.steps_per_observe
    ref = Runner(cfg, slam_map, "FASTSLAM1", n_particles=16,
                 device="cpu").run_checkpointed(
        seed=4, n_ticks=n_ticks, every=10, ckpt_path=str(tmp_path / "clean"))
    flaky = FlakyRunner(cfg, slam_map, "FASTSLAM1", n_particles=16,
                        device="cpu")
    got = run_resilient(flaky, seed=4, n_ticks=n_ticks, every=10,
                        ckpt_path=str(tmp_path / "flaky"), backoff_s=0.0)
    assert "run failed (RuntimeError: injected failure); retry 1/3" in (
        capsys.readouterr().err)
    assert len(got.est_pose) == 20
    assert_results_equal(ref, got)


@pytest.mark.parametrize("kind", ["FASTSLAM1", "EKF1"])
def test_jax_resumes_a_port_checkpoint(tmp_path, kind):
    n, cut, every, P, seed = 40, 20, 10, 16, 3
    jcfg, jmap, cfg, slam_map = configs(**NOISE_OFF)
    period = cfg.steps_per_observe
    port = Runner(cfg, slam_map, kind, n_particles=P, device="cpu")
    full = port.run(seed=seed, n_ticks=n * period)
    part = str(tmp_path / "port")
    port.run_checkpointed(seed=seed, n_ticks=cut * period, every=every,
                          ckpt_path=part)
    sim_state, est_state, _, superstep = load_checkpoint(
        part, None, port.est.init(P), device="cpu")
    assert superstep == cut
    path = str(tmp_path / "jax")
    save_jax_checkpoint(path, sim_state, est_state, superstep, seed,
                        meta={"method": kind})
    with np.load(path + ".npz") as data:
        np.testing.assert_array_equal(data["key"],
                                      np.asarray(jax.random.PRNGKey(seed + 1)))
        np.testing.assert_array_equal(data["sim_5"],
                                      np.asarray(jax.random.PRNGKey(seed)))

    tail = JRunner(jcfg, jmap, kind, n_particles=P).run_checkpointed(
        seed=seed, n_ticks=n * period, every=every, ckpt_path=path,
        resume=True)
    assert tail.est_pose.shape == (n - cut, 3)
    assert np.isfinite(tail.est_pose).all()
    np.testing.assert_allclose(tail.true_pose, full.true_pose[cut:],
                               rtol=1e-4, atol=1e-4)
    if kind == "EKF1":
        np.testing.assert_allclose(tail.est_pose, full.est_pose[cut:],
                                   rtol=1e-4, atol=1e-4)
        for f in ("n", "da_table"):
            np.testing.assert_array_equal(
                np.asarray(getattr(tail.final_state, f)),
                getattr(full.final_state, f).numpy(), err_msg=f)
    with open(path + ".json") as fh:
        assert json.load(fh)["superstep"] == n


def test_save_jax_checkpoint_refuses_a_deferred_state(tmp_path):
    _, _, cfg, slam_map = configs()
    runner = port_runner("deferred", cfg, slam_map)
    sim_state, est_state, _, _ = runner._init(3)
    with pytest.raises(ValueError, match="DeferredState"):
        save_jax_checkpoint(str(tmp_path / "d"), sim_state, est_state, 0, 3)


# ---------------------------------------------------------------------------
# Sharded runs
# ---------------------------------------------------------------------------

RING40 = dict(ini="ring40.ini", mat="ring40.mat")
SHARDED_FS1 = dict(world=RING40, P=64, seed=3, supersteps=60, chunk=20,
                   cut=40)
SHARDED_EKF = dict(SHARDED_FS1, world=dict(
    RING40, config=dict(SWITCH_HEADING_KNOWN=1)))


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    import torch_parallel_workers as tw
    return tw.run_world(tw.checkpoint_world, 2,
                        tmp=str(tmp_path_factory.mktemp("sharded")),
                        fs1=SHARDED_FS1, ekf=SHARDED_EKF)


@pytest.mark.parametrize("kind", ["fs1", "ekf"])
def test_sharded_resume_is_bit_exact(sharded_runs, kind):
    """The resumed run's traces (from the cut on) and gathered final
    state equal the unbroken run's, on both ranks."""
    cut = SHARDED_FS1["cut"]
    for world in sharded_runs:
        full, part = world[kind]["unbroken"], world[kind]["resumed"]
        for key, value in full["traces"].items():
            np.testing.assert_array_equal(part["traces"][key], value[cut:],
                                          err_msg=key)
        assert part["state"].keys() == full["state"].keys()
        for key, value in full["state"].items():
            np.testing.assert_array_equal(part["state"][key], value,
                                          err_msg=key)
    fs = sharded_runs[0][kind]["unbroken"]["state"]
    assert int(fs["n"]) > 0


def test_a_sharded_run_writes_one_checkpoint(sharded_runs):
    for world in sharded_runs:
        for kind in ("fs1", "ekf"):
            for run in world[kind].values():
                assert run["files"] == ["run.json", "run.npz"]


def test_sharded_resume_on_another_mesh_raises(sharded_runs):
    for world in sharded_runs:
        errors = world["errors"]
        assert "(2,) mesh" in errors["single"]
        assert "(1,) mesh" in errors["single"]
        assert "(2,) mesh" in errors["none"] and "no mesh" in errors["none"]
