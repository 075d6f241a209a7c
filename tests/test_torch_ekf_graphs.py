"""The block EKF's update in segments (``parallel.ekf._Segments``), and
its replay from CUDA graphs on the card (``parallel.ekf._UpdateGraphs``)
with the association's decision an eager call between them.

On the CPU:

- the segmented body, run eagerly, bit for bit the former
  ``_update_local`` (kept below as it was), on a drive of the
  simulator's stream and on random states with heading terms pending,
  association known and unknown;
- the path each call takes: a state on the card with no group goes to
  the graphs, one with a group (a mesh rank) or off the card runs
  eagerly; ``update_graphs.eager`` counts every update of a run on the
  CPU, and nothing is replayed or captured;
- ``benchmark/metrics/ekf_update_replay_share.py``: None without the
  counter or with no update, the share with it.

On a card (``-m cuda``), at 10,000 landmarks from a start driven 100
supersteps (one state for the module):

- 80 supersteps replayed against the same 80 eager: the states and the
  nine traces bit-equal, the replayed run under
  ``torch.cuda.set_sync_debug_mode("error")``, one capture and 80
  replays counted;
- a state cloned to new addresses recaptures, as counted, and stays
  equal; at most two captures are kept, and none holds the state's
  tensors (a state let go frees its Pmm);
- a stand-in for ``gated_nearest`` sees every replayed update, and one
  that returns another association changes the result as it changes an
  eager update's;
- a state returned by one call is unchanged after the next.

Jax-free; torch on one thread.
"""

import importlib.util
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import test_torch_ekf_reference as ter
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models.ekf import (
    full_f32,
    gated_nearest,
    innovation_stats,
    known_association,
)
from slam_tpu_torch.ops.jacobians import compute_jacobians
from slam_tpu_torch.ops.kalman import cholesky_lower, innovation, solve_lower
from slam_tpu_torch.parallel import ekf as pk
from slam_tpu_torch.parallel.mesh import all_gather_rows, psum
from slam_tpu_torch.runtime import Runner
from slam_tpu_torch.spans import span

ROOT = Path(__file__).resolve().parents[1]
DRIVE = 12


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _former_update_local(state, z, ids, zmask, R, Re, gate_reject,
                         gate_augment, association_known, shard):
    """``parallel.ekf._update_local`` before its segments, as it was."""
    K = z.shape[0]
    L = state.capacity
    N2 = 2 * L
    dev = state.x.device
    row_lo, rows = shard.row_lo, shard.rows

    with span("ekf.associate"):
        hk = state.hk[:, :state.hk_n]
        lm = state.x[3:].reshape(L, 2)
        valid = torch.arange(L, device=dev) < state.n
        Pjj = all_gather_rows(pk._diag_blocks_local(state.Pmm, row_lo),
                              shard.group)
        hk_blk = hk.reshape(L, 2, hk.shape[1])
        Pjj = Pjj - torch.einsum("lad,lbd->lab", hk_blk, hk_blk)
        if association_known:
            assoc, is_new = known_association(state.da_table, ids, zmask)
        else:
            nis, nd = innovation_stats(state.pose, lm, valid, state.P00,
                                       state.P0m.T.reshape(L, 2, 3), Pjj,
                                       z, zmask, Re)
            assoc, is_new = gated_nearest(nis, nd, zmask, gate_reject,
                                          gate_augment)

    with span("ekf.gain"):
        matched = assoc >= 0
        slot = torch.where(matched, assoc, 0).long()
        zp, Hv, Hf, _ = compute_jacobians(state.pose, lm[slot], Pjj[slot],
                                          R)
        Hv = torch.where(matched[:, None, None], Hv, 0.0)
        Hf = torch.where(matched[:, None, None], Hf, 0.0)
        Hp = Hv.reshape(2 * K, 3)
        gcol = (2 * slot[:, None] + torch.arange(2, device=dev)).reshape(-1)
        v = torch.where(matched[:, None], innovation(z, zp),
                        0.0).reshape(2 * K)
        P0m_obs = state.P0m[:, gcol].reshape(3, K, 2)
        PHt_p = state.P00 @ Hp.T + torch.einsum(
            "ckb,kab->cka", P0m_obs, Hf).reshape(3, 2 * K)
        obs_rows = psum(pk._owned_rows(state.Pmm, gcol, row_lo),
                        shard.group)
        obs_rows = obs_rows - hk[gcol] @ hk.T
        HmP = torch.einsum("kab,kbn->kan", Hf, obs_rows.reshape(K, 2, N2)
                           ).reshape(2 * K, N2)
        PHt_m_loc = (state.P0m[:, row_lo:row_lo + rows].T @ Hp.T
                     + HmP[:, row_lo:row_lo + rows].T)
        HmPHt = psum(torch.einsum(
            "kab,kbc->kac", Hf,
            pk._owned_rows(PHt_m_loc, gcol, row_lo).reshape(K, 2, 2 * K)),
            shard.group)
        S = Hp @ PHt_p + HmPHt.reshape(2 * K, 2 * K)
        RR = torch.kron(torch.eye(K, dtype=S.dtype, device=dev), R)
        S = 0.5 * (S + S.T) + RR
        S = S + 1e-6 * torch.trace(S) / (2 * K) * torch.eye(
            2 * K, dtype=S.dtype, device=dev)
        Lc = cholesky_lower(S)
        W1_p = solve_lower(Lc, PHt_p.T).T
        W1_m_loc = solve_lower(Lc, PHt_m_loc.T).T
        W1_m = all_gather_rows(W1_m_loc, shard.group)
        sv = solve_lower(Lc, v)
        x = state.x + torch.cat([W1_p @ sv, W1_m @ sv])
        x[2] = wrap_angle(x[2])
        P00 = state.P00 - W1_p @ W1_p.T
        P0m = state.P0m - W1_p @ W1_m.T

    with span("ekf.pmm"):
        pk.pmm_passes.count += 1
        W = torch.cat([W1_m, hk], 1)
        Pmm = state.Pmm.addmm_(W[row_lo:row_lo + rows], W.T, alpha=-1.0)
        state = state._replace(x=x, P00=0.5 * (P00 + P00.T), P0m=P0m,
                               Pmm=Pmm, hk=state.hk.zero_(), hk_n=0)

    with span("ekf.augment"):
        return pk._augment_local(state, z, ids, is_new, Re, shard)


def _copy(state):
    """A NamedTuple of the filter's with each tensor in it copied."""
    return type(state)(*(v.clone() if isinstance(v, torch.Tensor) else v
                         for v in state))


def _assert_states_equal(a, b):
    for f in pk.SHARDED_FIELDS:
        u, w = getattr(a, f), getattr(b, f)
        if isinstance(u, torch.Tensor):
            assert u.dtype == w.dtype and torch.equal(u, w), f
        else:
            assert u == w, f


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _driven_case(known: int):
    """(estimator, config, state after DRIVE supersteps and the next
    superstep's predicts, that superstep's (z, ids, mask))."""
    cfg = ter.config(SWITCH_ASSOCIATION_KNOWN=known,
                     max_landmarks=ter.N_MAP)
    steps = ter.stream(cfg, ter.world(), DRIVE + 1)
    est = pk.ShardedEkfSlam(cfg, ter.N_MAP, device="cpu")
    state = est.init()
    for i, (ticks, z, ids, mask) in enumerate(steps):
        for v, g, phi in ticks:
            state = est.predict(state, None, _f32(v), _f32(g), _f32(phi))
        obs = (z.float(), ids.to(torch.int32), mask)
        if i < DRIVE:
            state = est.update(state, None, *obs)
    assert int(state.n) > 20 and state.hk_n == cfg.steps_per_observe
    return est, cfg, state, obs


def _random_case(known: int):
    """The reference test's random state with five heading terms
    pending, its superstep's predicts run."""
    cfg = ter.config(SWITCH_ASSOCIATION_KNOWN=known)
    est = pk.ShardedEkfSlam(cfg, ter.N_MAP, device="cpu")
    x, P, n, table, ticks, z, ids, mask = ter.random_case(7)
    state = ter.to_state(est, x, P, n, table, hk_n=5, seed=7)
    for v, g, phi in ticks:
        state = est.predict(state, None, _f32(v), _f32(g), _f32(phi))
    return est, cfg, state, (z.float(), ids.to(torch.int32), mask)


# --- the CPU --------------------------------------------------------------

@pytest.mark.parametrize("known", [0, 1], ids=["unknown", "known"])
@pytest.mark.parametrize("case", [_driven_case, _random_case],
                         ids=["drive", "random"])
def test_segments_equal_the_former_update(case, known):
    est, cfg, state, obs = case(known)
    args = (est.R, est.Re, cfg.GATE_REJECT, cfg.GATE_AUGMENT, bool(known),
            est.shard)
    with full_f32():
        got = pk._update_local(_copy(state), *obs, *args)
        want = _former_update_local(_copy(state), *obs, *args)
    _assert_states_equal(got, want)
    assert got.hk_n == 0 and int(got.n) >= int(state.n)
    assert not torch.equal(got.x, state.x)


def test_eager_counts_every_update_on_the_cpu():
    cfg = ter.config(max_landmarks=ter.N_MAP)
    est = pk.ShardedEkfSlam(cfg, ter.N_MAP, device="cpu")
    runner = Runner(cfg, ter.world(), "EKF1", estimator=est, device="cpu")
    before = dict(vars(pk.update_graphs))
    result = runner.run(seed=3, n_ticks=6 * cfg.steps_per_observe)
    after = vars(pk.update_graphs)
    assert int(result.final_state.n) > 0
    assert after["eager"] - before["eager"] == 6
    assert after["replays"] == before["replays"]
    assert after["captures"] == before["captures"]


@pytest.mark.parametrize("on_card,group,path", [
    (True, None, "graphs"), (True, "a mesh's group", "eager"),
    (False, None, "eager"), (False, "a mesh's group", "eager")])
def test_the_path_follows_the_device_and_the_group(monkeypatch, on_card,
                                                   group, path):
    """The graphs take a state on the card with no group; a mesh rank
    (a group: collectives a graph would hold) and a state off the card
    run the segments eagerly, counted."""
    taken = []
    monkeypatch.setattr(pk, "_update_phases",
                        lambda seg, *a: taken.append("eager") or seg)
    monkeypatch.setattr(pk._GRAPHS, "update",
                        lambda seg, *a: taken.append("graphs") or seg)
    state = SimpleNamespace(x=SimpleNamespace(is_cuda=on_card),
                            da_table=None)
    shard = pk.Shard(row_lo=0, rows=4, group=group)
    eager = pk.update_graphs.eager
    seg = pk._update_local(state, None, None, None, None, None, 4.0, 25.0,
                           False, shard)
    assert taken == [path]
    assert isinstance(seg, pk._Segments) and seg.state is state
    assert seg.shard is shard
    assert pk.update_graphs.eager - eager == (path == "eager")


def _replay_share():
    path = ROOT / "benchmark" / "metrics" / "ekf_update_replay_share.py"
    spec = importlib.util.spec_from_file_location("replay_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("counter,want", [
    (None, None), (dict(replays=0, captures=0, eager=0), None),
    (dict(replays=0, captures=0, eager=7), 0.0),
    (dict(replays=4354, captures=46, eager=1), 100.0 * 4354 / 4355),
    (dict(replays=79, captures=1, eager=1), 100.0 * 79 / 80)],
    ids=["no-counter", "no-update", "eager-only", "window", "one-run"])
def test_replay_share_reader(monkeypatch, counter, want):
    if counter is None:
        monkeypatch.delattr(pk, "update_graphs")
    else:
        monkeypatch.setattr(pk, "update_graphs", SimpleNamespace(**counter))
    got = _replay_share()({"units": [], "trace": None})
    assert got == pytest.approx(want) if want is not None else got is None


# --- on the card ----------------------------------------------------------

L_CARD, START, SUPERSTEPS = 10_000, 100, 80


@pytest.fixture(scope="module")
def card_start():
    """ShardedEkfSlam at 10,000 landmarks (config #5's world, the
    benchmark's ekf10k: unknown association, 96 slots) on the card: (its
    runner, the simulator's vehicle and tick, the filter's state) after
    ``START`` supersteps from waypoint 0, seed 5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs replay only on a "
                    "card")
    from slam_tpu_torch.runtime.config5 import config5_setup
    cfg, slam_map = config5_setup(L_CARD, capacity=L_CARD, max_obs=96)
    cfg = cfg.replace(SWITCH_ASSOCIATION_KNOWN=0)
    dev = torch.device("cuda")
    est = pk.ShardedEkfSlam(cfg, slam_map.n_landmarks, device=dev)
    runner = Runner(cfg, slam_map, "EKF1", estimator=est, device=dev)
    sim_state, state, gen, _ = runner._init(5)
    superstep = runner._superstep_for(state)
    sim_state, state, _ = runner._chunk(superstep, sim_state, state, gen,
                                        START)
    torch.cuda.synchronize()
    assert int(state.n) > 100
    return runner, sim_state.vehicle, sim_state.tick, state


def _run_from(card_start, seed=11, n=SUPERSTEPS, state=None,
              syncs_raise=False):
    """``n`` supersteps of ``Runner._chunk`` from a copy of the start
    (or from ``state``), the noise from ``seed``, with ``syncs_raise``
    under ``set_sync_debug_mode("error")``: (final state, the nine
    traces on the host)."""
    from slam_tpu_torch.sim.simulator import SimState
    runner, vehicle, tick, start = card_start
    sim = runner.sim
    sim_state = SimState(vehicle=_copy(vehicle),
                         generator=sim.make_generator(seed), tick=tick)
    state = _copy(start) if state is None else state
    gen = sim.make_generator(seed + 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error" if syncs_raise else 0)
    try:
        _, state, traces = runner._chunk(runner._superstep_for(state),
                                         sim_state, state, gen, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return state, [t.cpu() for t in traces]


def _eager_update(state, z, ids, zmask, R, Re, gate_reject, gate_augment,
                  known, shard):
    """The segments run eagerly on the card (the path of a mesh rank)."""
    seg = pk._Segments(state, z, ids, zmask, R, Re, known, shard)
    return pk._update_phases(seg, gate_reject, gate_augment)


def _assert_runs_equal(a, b):
    _assert_states_equal(a[0], b[0])
    for i, (u, w) in enumerate(zip(a[1], b[1])):
        assert torch.equal(u, w), f"trace {i}"


def _counts():
    return dict(vars(pk.update_graphs))


def _delta(before):
    return {k: v - before[k] for k, v in vars(pk.update_graphs).items()}


@pytest.mark.cuda
def test_replay_equals_eager_at_10k_on_card(card_start, monkeypatch):
    """80 supersteps replayed (a capture at the first update of the new
    state, under ``set_sync_debug_mode("error")``) and the same 80 run
    eagerly: the states and the nine traces bit-equal."""
    before = _counts()
    replayed = _run_from(card_start, syncs_raise=True)
    assert _delta(before) == dict(replays=SUPERSTEPS, captures=1, eager=0)
    monkeypatch.setattr(pk, "_update_local", _eager_update)
    before = _counts()
    eager = _run_from(card_start)
    assert _delta(before) == dict(replays=0, captures=0, eager=0)
    _assert_runs_equal(replayed, eager)
    assert int(replayed[0].n) > int(card_start[3].n)


@pytest.mark.cuda
def test_new_addresses_recapture_on_card(card_start):
    """Three copies of the start, each at new addresses: a capture each,
    the same result each; two captures kept; a state let go frees its
    Pmm (no capture holds it)."""
    runs, refs = [], []
    before = _counts()
    for _ in range(3):
        state = _copy(card_start[3])
        refs.append(weakref.ref(state.Pmm))
        runs.append(_run_from(card_start, n=4, state=state))
        del state
    assert _delta(before) == dict(replays=12, captures=3, eager=0)
    assert len(pk._GRAPHS.captured) == pk._UpdateGraphs.KEYS == 2
    assert _equal_at_distinct_addresses(runs)
    runs.clear()
    assert all(ref() is None for ref in refs)


def _equal_at_distinct_addresses(runs) -> bool:
    """Every run equal to the first, and each run's Pmm at an address
    of its own."""
    for run in runs[1:]:
        _assert_runs_equal(runs[0], run)
    return len({run[0].Pmm.data_ptr() for run in runs}) == len(runs)


@pytest.mark.cuda
def test_the_decision_feeds_the_replayed_gain_on_card(card_start,
                                                     monkeypatch):
    """A stand-in for ``gated_nearest`` is called at every replayed
    update; one that returns another association (every third match
    dropped) gives another state, the same as an eager update's with
    that stand-in."""
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return gated_nearest(*args, **kw)

    def other(*args, **kw):
        assoc, is_new = gated_nearest(*args, **kw)
        drop = torch.arange(assoc.shape[0], device=assoc.device) % 3 == 0
        return torch.where(drop, -1, assoc), is_new

    monkeypatch.setattr(pk, "gated_nearest", spy)
    before = _counts()
    sound = _run_from(card_start, n=6)
    assert len(calls) == 6 and _delta(before)["replays"] == 6
    monkeypatch.setattr(pk, "gated_nearest", other)
    before = _counts()
    changed = _run_from(card_start, n=6)
    assert _delta(before)["replays"] == 6
    assert not torch.equal(changed[0].x, sound[0].x)
    monkeypatch.setattr(pk, "_update_local", _eager_update)
    _assert_runs_equal(changed, _run_from(card_start, n=6))


@pytest.mark.cuda
def test_a_returned_state_outlives_the_next_call_on_card(card_start,
                                                         monkeypatch):
    """The fresh fields of each update's state (x, P00, P0m, n) are the
    caller's: the replayed updates after it leave them as they were."""
    est = card_start[0].est
    inner, kept = est.update, []

    def update(*args, **kw):
        out = inner(*args, **kw)
        fresh = (out.x, out.P00, out.P0m, out.n)
        kept.append((fresh, [t.clone() for t in fresh]))
        return out

    monkeypatch.setattr(est, "update", update)
    before = _counts()
    _run_from(card_start, n=4)
    assert _delta(before)["replays"] == 4 and len(kept) == 4
    for fresh, copies in kept:
        for t, c in zip(fresh, copies):
            assert torch.equal(t, c)
    assert not torch.equal(kept[0][0][0], kept[-1][0][0])
