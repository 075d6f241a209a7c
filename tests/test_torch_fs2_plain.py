"""The port's FastSLAM 2 (``slam_tpu_torch.models.fastslam2``) against the
plain float64 reference ``tests/plain_fastslam2.py``, on the CPU, where
the kernel wrappers run their twins (K3's ``fs2_refine_plain``, K4's
``fused_update_plain``) and the predict runs eagerly; and its four spans.

On a seeded random particle state at P = 64, K = 6, L = 24 (12 live
landmarks, the observations matched, new and masked interleaved): one
predict tick with the heading known and unknown; the proposal's
refinement (xv_r, Pv_r); the sample from a given eps; the prior /
proposal weight term; the likelihood, the feature updates and the new
features at the sampled poses. Then a 3-superstep drive of ``Runner`` on
data/dense200 at P = 32, the reference stepped from the program's own
state at each stage. The two copies of the reference are one file.

Tolerances, each with its reason, and each under what the reference
itself reads in bfloat16 on the same inputs
(``test_bfloat16_fails_every_tolerance``):

- poses, ``POSE_TOL`` 5e-5 (m, rad): float32 rounding of coordinates of
  ~10 m (ulp ~1e-6) through a tick, or through a refinement of up to
  five steps (~1.2e-6 measured);
- pose covariances, ``COV_TOL`` 1e-5 relative to the particle's largest
  variance (~1e-7 measured);
- the prior / proposal term and the log likelihood, ``LOGW_TOL`` 2e-3
  relative to their size (at least 1): the term is a difference of two
  3x3 quadratic forms through the adjugate of a near-singular pose
  covariance, float32 moving it by ~1e-4 relative (the same reason
  tests/test_torch_fastslam2.py holds the port's logw to JAX's at rtol
  1e-3);
- landmark means ``LM_TOL`` 1e-4 m and covariances ``LMCOV_TOL`` 1e-5
  relative to their scale: one 2x2 EKF step in float32, at a sampled
  pose that float32 moves too (up to ~3e-5 m and ~1.1e-6 measured);
- n and the id table exactly.
"""

import contextlib
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import plain_fastslam2 as ref
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slam_tpu_torch import spans
from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import SlamMap, read_map_file
from slam_tpu_torch.models import FastSlam2, rbpf
from slam_tpu_torch.models import fastslam2 as fs2
from slam_tpu_torch.runtime.loop import Runner

ROOT = Path(__file__).resolve().parents[1]
P, K, L, N_MAP, N_LIVE = 64, 6, 24, 40, 12
POSE_TOL, COV_TOL, LOGW_TOL = 5e-5, 1e-5, 2e-3
LM_TOL, LMCOV_TOL = 1e-4, 1e-5
BF16 = torch.bfloat16
CFG = SlamConfig(V=2.0, WHEELBASE=2.0, sigmaV=0.3, sigmaG=0.0523,
                 sigmaT=0.0174, sigmaR=0.1, sigmaB=0.0174, max_landmarks=L,
                 max_observations=K)


def cfg_dict(cfg: SlamConfig) -> dict:
    return {k: getattr(cfg, k) for k in (
        "WHEELBASE", "DT_CONTROLS", "sigmaV", "sigmaG", "sigmaT",
        "SWITCH_HEADING_KNOWN")}


def noise_R(est) -> tuple:
    return ((float(est.R[0, 0]), 0.0), (0.0, float(est.R[1, 1])))


@pytest.fixture(scope="module")
def case():
    """A particle state (poses ~N around (3, 4, 0.2), pose covariances
    of ~1e-4, 12 live landmarks scattered around their centres, random
    weights) and a batch of K observations: four matched, one new, one
    masked."""
    g = torch.Generator().manual_seed(24)
    est = FastSlam2(CFG, N_MAP, device="cpu")
    st = est.init(P)
    xv = torch.stack([3 + 0.5 * torch.randn(P, generator=g),
                      4 + 0.5 * torch.randn(P, generator=g),
                      0.2 + 0.05 * torch.randn(P, generator=g)])
    A = 0.01 * torch.randn((P, 3, 3), generator=g, dtype=torch.float64)
    Pv = ref.packed(A @ A.transpose(1, 2) + 1e-5 * torch.eye(
        3, dtype=torch.float64)).float()
    cent = torch.rand((N_LIVE, 2), generator=g) * 16 - 2
    lm = torch.zeros(2, est.capacity, P)
    lm_P = torch.zeros(3, est.capacity, P)
    lm[:, :N_LIVE] = cent.T[:, :, None] + 0.2 * torch.randn(
        (2, N_LIVE, P), generator=g)
    lm_P[0, :N_LIVE] = 0.02 + 0.01 * torch.rand((N_LIVE, P), generator=g)
    lm_P[2, :N_LIVE] = 0.02 + 0.01 * torch.rand((N_LIVE, P), generator=g)
    lm_P[1, :N_LIVE] = 0.004 * torch.randn((N_LIVE, P), generator=g)
    table = torch.full((N_MAP,), -1, dtype=torch.int32)
    live = torch.randperm(N_MAP, generator=g)[:N_LIVE]
    table[live] = torch.arange(N_LIVE, dtype=torch.int32)
    new_id = int(torch.nonzero(table < 0)[0])
    ids = torch.tensor([int(live[3]), new_id, int(live[7]), int(live[0]),
                        int(live[9]), int(live[5])], dtype=torch.int32)
    mask = torch.tensor([True, True, True, False, True, True])
    pose = xv.mean(1)
    z = torch.zeros(K, 2)
    for k in range(K):
        s = int(table[ids[k]])
        d = (cent[s] if s >= 0 else torch.tensor([9.0, 2.0])) - pose[:2]
        z[k, 0] = d.norm() + 0.05
        z[k, 1] = torch.atan2(d[1], d[0]) - pose[2] + 0.01
    st = st._replace(xv=xv, Pv=Pv, lm=lm, lm_P=lm_P,
                     n=torch.tensor(N_LIVE, dtype=torch.int32),
                     da_table=table,
                     logw=0.1 * torch.randn(P, generator=g))
    eps = torch.randn((3, P), generator=g)
    return dict(est=est, st=st, z=z, ids=ids, mask=mask, eps=eps)


def clone(st):
    return st._replace(**{k: v.clone() for k, v in st._asdict().items()
                          if isinstance(v, torch.Tensor)})


def pose_gap(got, want) -> float:
    d = (got.double() - want.double()).abs()
    d[2] = ref.wrap(got[2].double() - want[2].double()).abs()
    return float(d.max())


def cov_gap(got, want) -> float:
    scale = want.double()[[0, 3, 5]].max(0).values
    return float(((got.double() - want.double()).abs() / scale).max())


def rel_gap(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def lm_gaps(lm, lm_P, lm_r, lmP_r) -> tuple:
    scale = torch.sqrt(lmP_r[0] * lmP_r[2]).clamp(min=1e-12)
    return (float((lm.double() - lm_r.double()).abs().max()),
            float(((lm_P.double() - lmP_r.double()).abs() / scale).max()))


def tick(case, known: int):
    cfg = CFG.replace(SWITCH_HEADING_KNOWN=known)
    est = FastSlam2(cfg, N_MAP, device="cpu")
    st = est.predict(clone(case["st"]), torch.Generator().manual_seed(1),
                     torch.tensor(2.0), torch.tensor(0.1),
                     torch.tensor(0.25))
    return cfg, st


@pytest.mark.parametrize("known", [0, 1])
def test_predict_tick(case, known):
    cfg, st = tick(case, known)
    xv, Pv = ref.predict(case["st"].xv, case["st"].Pv,
                         torch.tensor([[2.0, 0.1, 0.25]]), cfg_dict(cfg))
    assert pose_gap(st.xv, xv) < POSE_TOL
    assert cov_gap(st.Pv, Pv) < COV_TOL
    if known:     # the heading update moved every particle
        plain = tick(case, 0)[1]
        assert float((st.xv[2] - plain.xv[2]).abs().min()) > 1e-6


def proposal(case):
    """(the port's xv_r, Pv_r, its state after fs2_propose, the
    reference's xv_r, Pv_r)."""
    st, est = clone(case["st"]), case["est"]
    z, ids, mask = case["z"], case["ids"], case["mask"]
    slot, matched, _ = rbpf.associate_slots(st, ids, mask)
    assert 0 < int(matched.sum()) < int(mask.sum())
    gathered = rbpf.gather_landmarks(st, slot)
    xv_r, Pv_r = fs2._refine_proposal(st, z, matched, gathered, est.R)
    out = fs2.fs2_propose(st, z, mask, matched, gathered, est.R,
                          case["eps"])
    rslot, rmatched, _ = ref.associate(st.da_table, ids, mask)
    assert torch.equal(rmatched, matched)
    rxv, rPv = ref.refine(st.xv, st.Pv, st.lm, st.lm_P, z, rslot, rmatched,
                          noise_R(est))
    return xv_r, Pv_r, out, rxv, rPv


def test_proposal_refinement(case):
    xv_r, Pv_r, _, rxv, rPv = proposal(case)
    assert pose_gap(xv_r, rxv) < POSE_TOL
    assert cov_gap(Pv_r, rPv) < COV_TOL
    # The refinement moved the poses and shrank the covariances.
    assert pose_gap(rxv, case["st"].xv) > 100 * POSE_TOL
    assert bool((rPv[0] < case["st"].Pv[0].double()).all())


def test_proposal_sample(case):
    _, _, out, rxv, rPv = proposal(case)
    assert pose_gap(out.xv, ref.sample(rxv, rPv, case["eps"])) < POSE_TOL
    assert bool((out.Pv == 0).all())
    eps = ref.noise_of(rxv, rPv, out.xv)
    assert float((eps - case["eps"].double()).abs().max()) < 1e-2


def test_weight_term(case):
    _, _, out, rxv, rPv = proposal(case)
    st = case["st"]
    corr = ref.log_weight(st.xv, st.Pv, rxv, rPv, out.xv)
    assert float(corr.abs().max()) > 0.1
    assert rel_gap(out.logw - st.logw, corr) < LOGW_TOL


def test_features_at_the_sampled_pose(case):
    est, z, ids, mask = case["est"], case["z"], case["ids"], case["mask"]
    _, _, out, _, _ = proposal(case)
    xvs, logw0 = out.xv.clone(), out.logw.clone()
    lm0, lmP0 = out.lm.clone(), out.lm_P.clone()
    slot, matched, is_new = rbpf.associate_slots(out, ids, mask)
    post = fs2.fs1_observe(out, z, ids, slot, matched, is_new, est.R)
    ll, lm_r, lmP_r, n_r, table_r = ref.observe(
        xvs, lm0, lmP0, N_LIVE, case["st"].da_table, z, ids, mask,
        noise_R(est))
    assert rel_gap(post.logw - logw0, ll) < LOGW_TOL
    gap_m, gap_c = lm_gaps(post.lm, post.lm_P, lm_r, lmP_r)
    assert gap_m < LM_TOL and gap_c < LMCOV_TOL
    assert int(post.n) == n_r == N_LIVE + 1
    assert torch.equal(post.da_table.long(), table_r)


def test_bfloat16_fails_every_tolerance(case):
    """The reference in bfloat16 in the port's place, on the same
    inputs, reads over each tolerance."""
    st, est = case["st"], case["est"]
    z, ids, mask = case["z"], case["ids"], case["mask"]
    R = noise_R(est)
    cfg = cfg_dict(CFG.replace(SWITCH_HEADING_KNOWN=1))
    ticks = torch.tensor([[2.0, 0.1, 0.25]])
    xv, Pv = ref.predict(st.xv, st.Pv, ticks, cfg)
    xb, Pb = ref.predict(st.xv, st.Pv, ticks, cfg, BF16)
    assert pose_gap(xb, xv) > POSE_TOL and cov_gap(Pb, Pv) > COV_TOL
    slot, matched, _ = ref.associate(st.da_table, ids, mask)
    rxv, rPv = ref.refine(st.xv, st.Pv, st.lm, st.lm_P, z, slot, matched, R)
    bxv, bPv = ref.refine(st.xv, st.Pv, st.lm, st.lm_P, z, slot, matched, R,
                          BF16)
    assert pose_gap(bxv, rxv) > POSE_TOL and cov_gap(bPv, rPv) > COV_TOL
    xvs = ref.sample(rxv, rPv, case["eps"])
    assert pose_gap(ref.sample(rxv, rPv, case["eps"], BF16), xvs) > POSE_TOL
    corr = ref.log_weight(st.xv, st.Pv, rxv, rPv, xvs)
    corr_b = ref.log_weight(st.xv, st.Pv, rxv, rPv, xvs, BF16)
    assert rel_gap(corr_b, corr) > LOGW_TOL
    args = (xvs, st.lm, st.lm_P, N_LIVE, st.da_table, z, ids, mask, R)
    ll, lm_r, lmP_r, _, _ = ref.observe(*args)
    ll_b, lm_b, lmP_b, _, _ = ref.observe(*args, dtype=BF16)
    assert rel_gap(ll_b, ll) > LOGW_TOL
    gap_m, gap_c = lm_gaps(lm_b, lmP_b, lm_r, lmP_r)
    assert gap_m > LM_TOL and gap_c > LMCOV_TOL


def test_the_two_copies_of_the_reference_are_one():
    bench = ROOT / "benchmark" / "reference" / "fastslam2.py"
    assert bench.read_bytes() == (ROOT / "tests"
                                  / "plain_fastslam2.py").read_bytes()
    spec = importlib.util.spec_from_file_location("bench_fastslam2", bench)
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    g = torch.Generator().manual_seed(5)
    n = 16
    xv = torch.randn((3, n), generator=g, dtype=torch.float64)
    Pv = ref.packed(torch.eye(3, dtype=torch.float64).expand(n, 3, 3)
                    * 1e-3)
    lm = torch.zeros((2, 8, n), dtype=torch.float64)
    lm[:, :2] = 5 + torch.randn((2, 2, n), generator=g,
                                dtype=torch.float64)
    lm_P = torch.zeros((3, 8, n), dtype=torch.float64)
    lm_P[0, :2] = lm_P[2, :2] = 0.05
    table = torch.tensor([0, -1, 1, -1])
    z = torch.tensor([[7.0, 0.7], [3.0, -0.4], [7.1, 0.8]])
    ids, mask = torch.tensor([0, 1, 2]), torch.tensor([True, True, True])
    eps = torch.randn((3, n), generator=g, dtype=torch.float64)
    args = (torch.zeros(n, dtype=torch.float64), xv, Pv, lm, lm_P, 2,
            table, z, ids, mask, ((0.01, 0.0), (0.0, 3e-4)), eps)
    a, b = ref.update(*args), copy.update(*args)
    assert a["n"] == b["n"] == 3
    for key in ("xv_r", "Pv_r", "xv", "logw", "lm", "lm_P", "table"):
        assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# A drive through Runner on data/dense200
# ---------------------------------------------------------------------------

DRIVE_P, DRIVE_STEPS = 32, 3


class Spy:
    """``FastSlam2`` that keeps, per superstep, the state before its
    first predict, the ticks, the state that reaches the update, the
    update's eps and dithers (redrawn from a copy of its generator), the
    state that reaches the resample and the state it returns."""

    def __init__(self, est):
        self.est, self.rows, self.row = est, [], None

    def __getattr__(self, name):
        return getattr(self.est, name)

    def predict(self, state, gen, vn, gn, phi):
        if self.row is None:
            self.row = dict(xv0=state.xv.clone(), Pv0=state.Pv.clone(),
                            ticks=[])
        self.row["ticks"].append([float(vn), float(gn), float(phi)])
        return self.est.predict(state, gen, vn, gn, phi)

    def update(self, state, gen, z, ids, zmask):
        row, self.row = self.row, None
        copy = torch.Generator().manual_seed(0)
        copy.set_state(gen.get_state())
        P = state.n_particles
        row.update(pre=clone(state), obs=(z.clone(), ids.clone(),
                                          zmask.clone()),
                   eps=torch.randn((3, P), generator=copy),
                   dither=torch.rand(P, generator=copy))
        inner = rbpf.resample

        def seen(st, *a, **kw):
            row["mid"] = clone(st)
            return inner(st, *a, **kw)
        rbpf.resample = seen
        try:
            out = self.est.update(state, gen, z, ids, zmask)
        finally:
            rbpf.resample = inner
        row["post"] = clone(out)
        self.rows.append(row)
        return out


def dense200():
    """dense200 shifted so that waypoint 0, the vehicle's start, is the
    origin (the benchmark's world); at a range of 40 m the vehicle sees
    ~5 landmarks from its first superstep on, and at NEFFECTIVE 99 the
    resample's gate fires on nearly every update."""
    cfg = SlamConfig.from_ini(str(ROOT / "data" / "dense200.ini")).replace(
        MAX_RANGE=40.0, NEFFECTIVE=99)
    m = read_map_file(str(ROOT / "data" / "dense200.mat"))
    shift = m.waypoints[0].copy()
    return cfg, SlamMap(landmarks=m.landmarks - shift,
                        waypoints=m.waypoints - shift)


@pytest.fixture(scope="module")
def drive():
    cfg, slam_map = dense200()
    spy = Spy(FastSlam2(cfg, slam_map.n_landmarks, device="cpu"))
    runner = Runner(cfg, slam_map, "FASTSLAM2", n_particles=DRIVE_P,
                    estimator=spy, device="cpu")
    result = runner.run(seed=7, n_ticks=DRIVE_STEPS
                        * cfg.steps_per_observe)
    return cfg, spy.est, spy.rows, result


def test_drive_against_the_reference(drive):
    cfg, est, rows, result = drive
    assert len(rows) == DRIVE_STEPS
    R, fired = noise_R(est), 0
    for row in rows:
        pre, mid, post = row["pre"], row["mid"], row["post"]
        xv, Pv = ref.predict(row["xv0"], row["Pv0"],
                             torch.tensor(row["ticks"]), cfg_dict(cfg))
        assert pose_gap(pre.xv, xv) < POSE_TOL
        assert cov_gap(pre.Pv, Pv) < COV_TOL
        z, ids, mask = row["obs"]
        assert int(mask.sum()) >= 4
        u = ref.update(pre.logw, pre.xv, pre.Pv, pre.lm, pre.lm_P,
                       int(pre.n), pre.da_table, z, ids, mask, R,
                       row["eps"])
        assert pose_gap(mid.xv, u["xv"]) < POSE_TOL
        assert bool((mid.Pv == 0).all())
        logw_n = u["logw"] - torch.logsumexp(u["logw"], 0)
        mid_n = mid.logw.double() - torch.logsumexp(mid.logw.double(), 0)
        assert rel_gap(mid_n, logw_n) < LOGW_TOL
        assert int(post.n) == u["n"]
        assert torch.equal(post.da_table.long(), u["table"])
        # The resample, from the same dithers, at the reference's weights.
        _, _, fire = ref.resample_decision(u["logw"], est.n_min(DRIVE_P))
        anc = (ref.stratified_ancestors(torch.exp(logw_n), row["dither"])
               if fire else torch.arange(DRIVE_P))
        fired += fire
        assert torch.equal(post.xv, mid.xv[:, anc])
        gap_m, gap_c = lm_gaps(post.lm, post.lm_P, u["lm"][..., anc],
                               u["lm_P"][..., anc])
        assert gap_m < LM_TOL and gap_c < LMCOV_TOL
    assert int(rows[-1]["post"].n) >= int(rows[0]["post"].n) > 0
    assert all(bool(ref.associate(r["pre"].da_table, *r["obs"][1:])[1]
                    .any()) for r in rows[1:])       # K3 refined
    last = rows[-1]["post"]
    pose = ref.pose_estimate(last.logw, last.xv)
    assert float((pose[:2] - torch.as_tensor(result.est_pose[-1][:2])
                  .double()).norm()) < POSE_TOL
    assert fired >= 1


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

def short_run(profiled: bool, seed: int = 3):
    cfg, slam_map = dense200()
    runner = Runner(cfg, slam_map, "FASTSLAM2", n_particles=DRIVE_P,
                    device="cpu")
    ctx = (profile(activities=[ProfilerActivity.CPU]) if profiled
           else contextlib.nullcontext())
    with ctx:
        result = runner.run(seed=seed,
                            n_ticks=DRIVE_STEPS * cfg.steps_per_observe)
    return cfg, result


def test_each_update_and_tick_records_its_spans():
    spans.clear()
    try:
        cfg, _ = short_run(True)
        recs = spans.records()
    finally:
        spans.clear()
    names = {r[1]: r[0] for r in recs}
    count = {}
    for r in recs:
        count[r[0]] = count.get(r[0], 0) + 1
    assert count["filter.update"] == DRIVE_STEPS
    assert count["filter.predict"] == DRIVE_STEPS * cfg.steps_per_observe
    for name, parent in (("fs2.associate", "filter.update"),
                         ("fs2.propose", "filter.update"),
                         ("fs2.map", "filter.update"),
                         ("fs2.heading", "filter.predict")):
        assert count[name] == count[parent], name
        for r in recs:
            if r[0] == name:
                assert names[r[2]] == parent, (name, names[r[2]])
    # Each update's three spans in order, inside it.
    for up in (r for r in recs if r[0] == "filter.update"):
        kids = sorted((r for r in recs if r[2] == up[1]),
                      key=lambda r: r[3])
        fs2_kids = [r[0] for r in kids if r[0].startswith("fs2.")]
        assert fs2_kids == ["fs2.associate", "fs2.propose", "fs2.map"]
        assert all(up[3] <= r[3] <= r[4] <= up[4] for r in kids)


def digest(result) -> str:
    h = hashlib.sha256()
    for name in ("true_pose", "est_pose", "obs_z", "obs_ids"):
        h.update(np.ascontiguousarray(getattr(result, name)).tobytes())
    for t in result.final_state:
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def test_spans_change_no_arithmetic(monkeypatch):
    """A run with the spans recording, one with them off, and one with
    ``span`` a bare null context (a program without the FastSLAM 2
    spans) give the same final state and traces, bit for bit."""
    spans.clear()
    try:
        on = digest(short_run(True)[1])
    finally:
        spans.clear()
    off = digest(short_run(False)[1])
    monkeypatch.setattr(fs2, "span", lambda name: contextlib.nullcontext())
    bare = digest(short_run(False)[1])
    assert on == off == bare
