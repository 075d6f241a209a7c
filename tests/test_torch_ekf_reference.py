"""The port's EKFs against the plain float64 reference (``plain_ekf``), on
the CPU: ``parallel.ekf.ShardedEkfSlam`` with no mesh (the block form,
heading terms deferred in ``hk``) and ``models.ekf.EkfSlam`` (the dense
form).

From one state, each estimator and the reference take the same inputs:
the predicts of a superstep's ticks with the IMU heading observed, the
association, the update and the augment. Compared phase by phase (after
the predicts; the association; after the update) and for whole
supersteps, on seeded random states with heading terms already pending
and on a drive of the port's simulator stream through a world with
landmarks in view from the first tick, association unknown (the
benchmark's ekf10k) and known:

- the mean, and the covariance with the deferred terms folded
  (stored Pmm - hk hk'), at the tolerances below;
- ``n`` and ``da_table`` exactly;
- the association and new-ness exactly, but where the reference finds a
  decision within ``MARGIN`` of flipping.

The reference run in bfloat16 on the same inputs fails the tolerances.
Jax-free, torch on one thread.
"""

import math

import numpy as np
import pytest
import torch

import plain_ekf as pe
from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import SlamMap, synthetic_map
from slam_tpu_torch.models import ekf as mk
from slam_tpu_torch.parallel import ekf as pk
from slam_tpu_torch.sim.simulator import Simulator

# The covariance, relative to its largest entry. Float32 rounding reads
# below 1e-7 (the reference itself in float32: 4e-8); the port adds a
# jitter of 1e-6 trace(S) / 2K to S's diagonal, which moves the update's
# term by ~1e-5 of its scale where S's bearing rows (sigmaB^2 = 3e-4)
# sit far under its range rows (1e-2): the drive reads up to 1.6e-5,
# the random states 4.2e-6. bfloat16 reads 0.17.
COV_RTOL = 5e-5
# The predicts and heading observes alone carry no jitter: float32
# roundings of a few products (reads up to ~2e-7).
PREDICT_COV_RTOL = 2e-6
# The mean in metres (and radians). Float32 rounding reads up to 1.4e-5
# m (a few ulp of 25-40 m coordinates; the reference itself in float32);
# the jitter on S moves the gain by ~1e-5 of itself, and the random
# states' updates move landmarks by metres: the port reads up to 6.5e-5
# m there, 8.5e-6 m on the drive. bfloat16 reads 0.33 m.
MEAN_ATOL = 2e-4
# A decision within this relative distance of flipping is not compared:
# float32 statistics carry ~1e-6 relative error.
MARGIN = 1e-4

CAP, N_MAP, K, T, D = 64, 200, 12, 8, 16
# The drive's capacity: its 10-12 observations a superstep fill it by
# the seventh superstep, after which new features overflow.
DRIVE_CAP = 20


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(**kw) -> SlamConfig:
    return SlamConfig(**{**dict(MAX_RANGE=30.0, SWITCH_HEADING_KNOWN=1,
                                SWITCH_ASSOCIATION_KNOWN=0,
                                max_landmarks=CAP, max_observations=K),
                         **kw})


def cfg_dict(cfg: SlamConfig) -> dict:
    return {k: getattr(cfg, k) for k in (
        "V", "WHEELBASE", "DT_CONTROLS", "sigmaV", "sigmaG", "sigmaR",
        "sigmaB", "sigmaT", "GATE_REJECT", "GATE_AUGMENT",
        "SWITCH_HEADING_KNOWN", "SWITCH_ASSOCIATION_KNOWN")}


# --- the estimators' states, dense (P) or in blocks ---------------------

def folded(state) -> torch.Tensor:
    """The joint covariance (float64), the deferred terms folded."""
    if hasattr(state, "P"):
        return state.P.double()
    hk = state.hk[:, :state.hk_n].double()
    Pmm = state.Pmm.double() - hk @ hk.T
    top = torch.cat([state.P00.double(), state.P0m.double()], 1)
    return torch.cat([top, torch.cat([state.P0m.double().T, Pmm], 1)])


def as_reference(state):
    """(x, P, n, table) in float64 from an estimator state."""
    return (state.x.double(), folded(state), int(state.n),
            state.da_table.long())


def to_state(est, x, P, n, table, hk_n=0, seed=0):
    """A state of ``est`` holding the float32 values of (x, P); for the
    block form with ``hk_n`` random heading terms pending (stored Pmm =
    P's landmark block + hk hk')."""
    x32, P32 = x.float(), P.float()
    tab = table.to(torch.int32)
    n = torch.tensor(n, dtype=torch.int32)
    if isinstance(est, mk.EkfSlam):
        return mk.EKFState(x=x32.clone(), P=P32.clone(), n=n, da_table=tab)
    hk = torch.zeros((2 * CAP, D))
    g = torch.Generator().manual_seed(seed)
    live = 2 * int(n)
    hk[:live, :hk_n] = 0.02 * torch.randn((live, hk_n), generator=g)
    return pk.ShardedEKFState(
        x=x32.clone(), P00=P32[:3, :3].clone(), P0m=P32[:3, 3:].clone(),
        Pmm=(P32[3:, 3:] + hk @ hk.T).contiguous(), n=n, da_table=tab,
        hk=hk, hk_n=hk_n)


ESTIMATORS = {
    "sharded": lambda cfg: pk.ShardedEkfSlam(cfg, N_MAP, device="cpu"),
    "dense": lambda cfg: mk.EkfSlam(cfg, N_MAP, device="cpu"),
}


class Spy:
    """Records the (assoc, is_new) the estimator's gated nearest
    neighbour returns (``gated_nearest``, looked up in the estimator's
    module at each call)."""

    def __init__(self, monkeypatch):
        self.got = []
        for mod in (pk, mk):
            inner = mod.gated_nearest

            def spy(*args, _inner=inner, **kw):
                out = _inner(*args, **kw)
                self.got.append(out)
                return out
            monkeypatch.setattr(mod, "gated_nearest", spy)


# --- inputs -------------------------------------------------------------

def random_case(seed: int, n_live: int = 20):
    """A random joint state with ``n_live`` landmarks around the pose,
    a superstep's T ticks (v, g, phi) and K observations: 8 of live
    landmarks (the first two of them of one landmark, ~0.1 m apart), 2
    of unseen ones far from any, 2 masked. Returns (x, P, n, table,
    ticks, z, ids, mask) in float64 (int64 ids)."""
    g = torch.Generator().manual_seed(seed)
    N = 3 + 2 * CAP
    M = 3 + 2 * n_live
    x = torch.zeros(N, dtype=torch.float64)
    x[:3] = torch.tensor([1.0, -0.5, 0.3]) + 0.1 * torch.randn(
        3, generator=g, dtype=torch.float64)
    ang = torch.rand(n_live, generator=g, dtype=torch.float64) * 2 * math.pi
    rad = 5.0 + 20.0 * torch.rand(n_live, generator=g, dtype=torch.float64)
    lm = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], 1)
    x[3:M] = (lm + x[:2]).reshape(-1)
    A = torch.randn((M, M), generator=g, dtype=torch.float64)
    P = torch.zeros((N, N), dtype=torch.float64)
    P[:M, :M] = 2e-3 * A @ A.T + 5e-3 * torch.eye(M, dtype=torch.float64)
    table = torch.full((N_MAP,), -1, dtype=torch.int64)
    perm = torch.randperm(N_MAP, generator=g)
    table[perm[:n_live]] = torch.arange(n_live)
    ticks = [(3.0 + 0.3 * float(torch.randn((), generator=g)),
              0.2 * float(torch.randn((), generator=g)),
              float(x[2]) + 0.05 * t / T) for t in range(T)]
    # Observations from roughly where the ticks leave the pose.
    pose = x[:3].clone()
    for v, gg, _ in ticks:
        pose = pose + torch.tensor([
            v * 0.025 * math.cos(gg + pose[2]), v * 0.025 * math.sin(
                gg + pose[2]), v * 0.025 * math.sin(gg) / 4.0],
            dtype=torch.float64)
    slots = torch.randperm(n_live, generator=g)[:7]
    pts = torch.cat([lm[slots[:1]] + x[:2] + 0.1, lm[slots] + x[:2],
                     torch.tensor([[60.0, 60.0], [-70.0, 40.0]],
                                  dtype=torch.float64)])
    d = pts - pose[:2]
    z = torch.zeros((K, 2), dtype=torch.float64)
    z[:10, 0] = d.norm(dim=1)
    z[:10, 1] = pe.wrap(torch.atan2(d[:, 1], d[:, 0]) - pose[2])
    z[:10] += torch.randn((10, 2), generator=g, dtype=torch.float64) * \
        torch.tensor([0.05, 0.005], dtype=torch.float64)
    inv = {int(s): i for i, s in enumerate(table.tolist()) if s >= 0}
    ids = torch.tensor([inv[int(slots[0])]] + [inv[int(s)] for s in slots]
                       + [int(perm[n_live]), int(perm[n_live + 1]), 0, 0])
    mask = torch.tensor([True] * 10 + [False] * 2)
    return x, P, n_live, table, ticks, z, ids, mask


def port_superstep(est, state, ticks, z, ids, mask, spy):
    """The estimator's superstep on float32 inputs: (the state after the
    predicts, as the reference reads it; (assoc, is_new), None for known
    association; the state after the update)."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)     # noqa: E731
    for v, g, phi in ticks:
        state = est.predict(state, None, f(v), f(g), f(phi))
    mid = as_reference(state)
    spy.got.clear()
    state = est.update(state, None, z.float(), ids.to(torch.int32), mask)
    decided = spy.got[0] if spy.got else None
    return mid, decided, state


def reference_predicts(x, P, ticks, cfg):
    Q, _ = pe.matrices(cfg_dict(cfg))
    for v, g, phi in ticks:
        x, P = pe.predict(x, P, v, g, Q, cfg.WHEELBASE, cfg.DT_CONTROLS)
        x, P = pe.observe_heading(x, P, phi, cfg.sigmaT)
    return x, P


def gaps(x, P, ref_x, ref_P):
    """(mean gap, covariance gap relative to its largest entry)."""
    return (float((x - ref_x).abs().max()),
            float((P - ref_P).abs().max() / ref_P.abs().max()))


def assert_association(decided, ref):
    """The port's association equals the reference's but at near-ties."""
    assoc, is_new = (t.long() for t in decided)
    sure = ~ref["tie"]
    assert torch.equal(assoc[sure], ref["assoc"][sure])
    assert torch.equal(is_new[sure].bool(), ref["is_new"][sure])


def assert_superstep(state, ref):
    mean, cov = gaps(state.x.double(), folded(state), ref["x"], ref["P"])
    assert mean < MEAN_ATOL, mean
    assert cov < COV_RTOL, cov
    assert int(state.n) == ref["n"]
    assert torch.equal(state.da_table.long(), ref["table"])


# --- seeded random states -----------------------------------------------

@pytest.mark.parametrize("name,hk_n", [("sharded", 0), ("sharded", 5),
                                       ("dense", 0)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_superstep_phase_by_phase(monkeypatch, name, seed, hk_n):
    """From a random state (for the block form also with heading terms
    pending): the predicts, the association and the update against the
    reference's, each from the port's own state before it."""
    spy = Spy(monkeypatch)
    cfg = config()
    est = ESTIMATORS[name](cfg)
    x, P, n, table, ticks, z, ids, mask = random_case(seed)
    state = to_state(est, x, P, n, table, hk_n, seed)
    x0, P0, _, _ = as_reference(state)
    mid, decided, state = port_superstep(est, state, ticks, z, ids, mask,
                                         spy)
    # The predicts and heading observes.
    rx, rP = reference_predicts(x0, P0, ticks, cfg)
    mean, cov = gaps(mid[0], mid[1], rx, rP)
    assert mean < MEAN_ATOL, mean
    assert cov < PREDICT_COV_RTOL, cov
    # The association, from the port's state after its predicts.
    _, R = pe.matrices(cfg_dict(cfg))
    zr = z.float().double()
    assoc, is_new, tie = pe.associate(mid[0], mid[1], n, zr, mask, R,
                                      cfg.GATE_REJECT, cfg.GATE_AUGMENT,
                                      MARGIN)
    ref = dict(assoc=assoc, is_new=is_new, tie=tie)
    assert_association(decided, ref)
    assert int(tie.sum()) == 0
    # Seven live landmarks matched (one of them twice), two new.
    assert int((assoc >= 0).sum()) == 8 and int(is_new.sum()) == 2
    # The update and augment with that association.
    ux, uP = pe.batch_update(mid[0], mid[1], zr, assoc, R)
    ux, uP, un, utab = pe.augment(ux, uP, n, mid[3], zr, ids, is_new, R)
    assert_superstep(state, dict(x=ux, P=uP, n=un, table=utab))
    assert un == n + 2


@pytest.mark.parametrize("name", ESTIMATORS)
@pytest.mark.parametrize("seed", [4, 5])
def test_whole_superstep_on_random_states(monkeypatch, name, seed):
    """One superstep of the reference from the port's starting state,
    with its own association throughout."""
    spy = Spy(monkeypatch)
    cfg = config()
    est = ESTIMATORS[name](cfg)
    x, P, n, table, ticks, z, ids, mask = random_case(seed)
    state = to_state(est, x, P, n, table, 3 if name == "sharded" else 0,
                     seed)
    start = as_reference(state)
    _, decided, state = port_superstep(est, state, ticks, z, ids, mask,
                                       spy)
    # The observations as the port sees them, float32.
    ref = pe.superstep(*start, ticks, z.float().double(), ids, mask,
                       cfg_dict(cfg), margin=MARGIN)
    assert_association(decided, ref)
    assert_superstep(state, ref)


# --- a drive of the simulator's stream ----------------------------------

def world():
    """200 landmarks around a 25 m loop, shifted so that waypoint 0,
    where the vehicle starts, is the origin (as ``config5_setup`` shifts
    its map): 10-12 observations a superstep from the first tick."""
    m = synthetic_map(N_MAP, n_waypoints=12, radius=25.0, seed=7)
    shift = m.waypoints[0].copy()
    return SlamMap(landmarks=m.landmarks - shift,
                   waypoints=m.waypoints - shift)


def stream(cfg, slam_map, n_supersteps: int, seed: int = 11):
    """The estimator's inputs from the port's simulator on the CPU, as
    ``Runner`` makes them for an EKF: per superstep its ticks' (v, g,
    phi) with the noisy IMU heading, then (z, ids, mask)."""
    sim = Simulator(cfg, slam_map, device="cpu")
    ss = sim.init(seed=seed)
    out = []
    for _ in range(n_supersteps):
        ss, ticks = sim.control_ticks(ss, cfg.steps_per_observe, imu=True)
        phis = [sim.heading_measurement(ss._replace(
            vehicle=ss.vehicle._replace(pose=p)), u)[1]
            for p, u in zip(ticks.poses, ticks.imu_draws)]
        ss, obs = sim.observe_step(ss)
        out.append(([(float(c[0]), float(c[1]), float(ph))
                     for c, ph in zip(ticks.controls, phis)],
                    obs.z.double(), obs.ids.long(), obs.mask))
    return out


DRIVE_SUPERSTEPS = 12


@pytest.mark.parametrize("assoc_known", [0, 1])
@pytest.mark.parametrize("name", ESTIMATORS)
def test_drive_superstep_by_superstep(monkeypatch, name, assoc_known):
    """Twelve supersteps from the filter's start: each against the
    reference's superstep from the port's state before it; the start
    itself exact; the slots full from the seventh superstep on."""
    spy = Spy(monkeypatch)
    cfg = config(SWITCH_ASSOCIATION_KNOWN=assoc_known,
                 max_landmarks=DRIVE_CAP)
    slam_map = world()
    est = ESTIMATORS[name](cfg)
    state = est.init()
    x0, P0, n0, t0 = pe.init(DRIVE_CAP, N_MAP)
    start = as_reference(state)
    assert torch.equal(start[0], x0) and torch.equal(start[1], P0)
    assert start[2] == n0 and torch.equal(start[3], t0)
    seen = matched = 0
    for ticks, z, ids, mask in stream(cfg, slam_map, DRIVE_SUPERSTEPS):
        start = as_reference(state)
        _, decided, state = port_superstep(est, state, ticks, z, ids, mask,
                                           spy)
        ref = pe.superstep(*start, ticks, z, ids, mask, cfg_dict(cfg),
                           margin=MARGIN)
        if assoc_known:
            assert decided is None
        else:
            assert_association(decided, ref)
        assert_superstep(state, ref)
        seen += int(mask.sum())
        matched += int((ref["assoc"] >= 0).sum())
    assert int(state.n) == DRIVE_CAP and matched >= seen // 2


def test_bfloat16_fails_the_tolerances(monkeypatch):
    """The reference run in bfloat16 in the port's place, on a drive's
    superstep and a random state: the covariance and the mean fail."""
    cfg = config(max_landmarks=DRIVE_CAP)
    steps = stream(cfg, world(), 4)
    x, P, n, table = pe.init(DRIVE_CAP, N_MAP)
    for ticks, z, ids, mask in steps[:3]:
        out = pe.superstep(x, P, n, table, ticks, z, ids, mask,
                           cfg_dict(cfg))
        x, P, n, table = out["x"], out["P"], out["n"], out["table"]
    cases = [(x, P, n, table, *steps[3])]
    xr, Pr, nr, tr, ticks, z, ids, mask = random_case(1)
    cases.append((xr, Pr, nr, tr, ticks, z, ids, mask))
    bf = torch.bfloat16
    for x, P, n, table, ticks, z, ids, mask in cases:
        ref = pe.superstep(x, P, n, table, ticks, z, ids, mask,
                           cfg_dict(cfg))
        low = pe.superstep(x.to(bf), P.to(bf), n, table, ticks, z.to(bf),
                           ids, mask, cfg_dict(cfg))
        mean, cov = gaps(low["x"].double(), low["P"].double(), ref["x"],
                         ref["P"])
        assert mean > 10 * MEAN_ATOL and cov > 10 * COV_RTOL, (mean, cov)


def test_reference_imports_torch_and_math_only():
    import ast
    from pathlib import Path
    tree = ast.parse(Path(pe.__file__).read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert names <= {"math", "torch", "__future__"}, names


def test_sequential_augment_equals_the_closed_form():
    """The reference adds features one after another; the port's
    ``models.ekf.ekf_augment`` adds them in closed form: equal states
    (float64 on both sides, so to rounding)."""
    cfg = config()
    x, P, n, table, _, z, ids, mask = random_case(6)
    is_new = torch.zeros(K, dtype=torch.bool)
    is_new[[1, 4, 8, 9]] = True
    _, R = pe.matrices(cfg_dict(cfg))
    rx, rP, rn, rt = pe.augment(x, P, n, table, z, ids, is_new, R)
    state = mk.EKFState(x=x.clone(), P=P.clone(),
                        n=torch.tensor(n, dtype=torch.int32),
                        da_table=table.to(torch.int32))
    out = mk.ekf_augment(state, z, ids.to(torch.int32), is_new, R)
    np.testing.assert_allclose(out.x.numpy(), rx.numpy(), atol=1e-12)
    np.testing.assert_allclose(out.P.numpy(), rP.numpy(), atol=1e-12)
    assert int(out.n) == rn == n + 4
    assert torch.equal(out.da_table.long(), rt)
