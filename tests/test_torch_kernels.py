"""The kernels of the port: plain twins against the JAX package's Pallas
kernels (interpret mode, as tests/test_pallas.py runs them), the CPU
dispatch of every wrapper, the build's errors, and, on a card, each CUDA
kernel against its twin.

Tolerances: the float kernels K2/K4 at rtol 1e-5, atol 1e-5 (the order
of the K-sum, and the two frameworks' float32 rounding); the gathers
G1/G2 bit-exact."""

import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.models import rbpf as jrbpf
from slam_tpu.models.particles import init_particles as jinit
from slam_tpu.ops import resampling as jrs
from slam_tpu.ops.pallas import gather as jgather
from slam_tpu.ops.pallas import kernels as jkernels
from slam_tpu_torch.models.particles import state_from_numpy
from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops.kernels import build
from slam_tpu_torch.ops.kernels import gather as tgather
from slam_tpu_torch.ops.kernels import kernels as tkernels

TOL = dict(rtol=1e-5, atol=1e-5)
R = np.diag([0.01, 0.0003]).astype(np.float32)


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


def _mid_run(P=256, L=16, n_map=24, seed=11):
    """A JAX ParticleState with 10 live slots, and an observation batch
    (z, ids, zmask) with matched, new (two of them) and masked
    entries."""
    rng = np.random.default_rng(seed)
    table = -np.ones(n_map, np.int32)
    table[2:12] = np.arange(10)
    lm_P = np.zeros((3, L, P), np.float32)
    lm_P[0], lm_P[2] = 0.1, 0.1
    lm_P[1] = 0.01
    state = jinit(P, L, n_map)._replace(
        logw=jnp.asarray(rng.normal(size=P).astype(np.float32)),
        xv=jnp.asarray(rng.normal(size=(3, P)).astype(np.float32) * 0.1),
        lm=jnp.asarray(rng.normal(size=(2, L, P)).astype(np.float32) * 5),
        lm_P=jnp.asarray(lm_P), n=jnp.int32(10),
        da_table=jnp.asarray(table))
    K = 5
    z = jnp.asarray(np.column_stack([rng.uniform(3, 8, K),
                                     rng.uniform(-0.5, 0.5, K)]
                                    ).astype(np.float32))
    ids = jnp.asarray(np.array([3, 15, 11, 20, 4], np.int32))
    zmask = jnp.asarray(np.array([True, True, True, True, False]))
    return state, z, ids, zmask


def _wide_run(P, L, n_map, seed):
    """A JAX ParticleState with 40 live slots, and a batch of K = 40
    observations in a shuffled order: 22 matched (more than two of K4's
    widest rounds, 8 events each, hold), 6 new and 12 masked."""
    rng = np.random.default_rng(seed)
    live = 40
    table = -np.ones(n_map, np.int32)
    table[rng.permutation(n_map)[:live]] = rng.permutation(live)
    lm_P = np.zeros((3, L, P), np.float32)
    lm_P[0], lm_P[2] = 0.1, 0.1
    lm_P[1] = 0.01
    state = jinit(P, L, n_map)._replace(
        logw=jnp.asarray(rng.normal(size=P).astype(np.float32)),
        xv=jnp.asarray(rng.normal(size=(3, P)).astype(np.float32) * 0.1),
        lm=jnp.asarray(rng.normal(size=(2, L, P)).astype(np.float32) * 5),
        lm_P=jnp.asarray(lm_P), n=jnp.int32(live),
        da_table=jnp.asarray(table))
    mapped, unmapped = np.flatnonzero(table >= 0), np.flatnonzero(table < 0)
    ids = np.concatenate([rng.choice(mapped, 22, replace=False),
                          rng.choice(unmapped, 6, replace=False),
                          rng.choice(mapped, 12)])
    zmask = np.arange(40) < 28
    order = rng.permutation(40)
    z = np.column_stack([rng.uniform(3, 8, 40), rng.uniform(-0.5, 0.5, 40)])
    return (state, jnp.asarray(z.astype(np.float32)),
            jnp.asarray(ids[order].astype(np.int32)),
            jnp.asarray(zmask[order]))


def _update_inputs(P=256, L=16, n_map=24, seed=11, run=_mid_run):
    """``run``'s state and batch, and the bookkeeping fs1_update
    derives from it: (state, z, slot, matched, slot_new, ok)."""
    state, z, ids, zmask = run(P, L, n_map, seed)
    assoc, is_new = jrbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)
    offset = jnp.cumsum(is_new.astype(jnp.int32)) - is_new.astype(jnp.int32)
    slot_new = state.n + offset
    ok = is_new & (slot_new < L)
    return state, z, slot, matched, slot_new, ok


def _update_args(state, z, slot, matched, slot_new, ok, device="cpu"):
    ts = state_from_numpy(state._asdict(), device)
    return (ts.xv, ts.logw, ts.lm, ts.lm_P, _t(z, device),
            _t(slot, device).to(torch.int32), _t(matched, device),
            _t(slot_new, device).to(torch.int32), _t(ok, device), R)


def _gather_arrays(P, L=4, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(c, P)) * 37).astype(np.float32)
            for c in (10, 2 * L, 3 * L)]


def _bounds(P, seed=6):
    import jax
    logw = (np.random.default_rng(seed).normal(size=P) * 2).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    csum = jrs._cumsum_2d(jnp.exp(jrs.normalize_log_weights(
        jnp.asarray(logw))))
    return np.asarray(jrs.offspring_bounds(key, csum, P))


# ---------------------------------------------------------------------------
# Plain twins against the JAX kernels
# ---------------------------------------------------------------------------

def test_k2_twin_matches_observe_call():
    """K2's twin against the JAX package's update at a P that is no
    multiple of 128: fs1_observe_tpu (the gather, _observe_call in
    interpret mode, the scatters and the weight delta), then
    add_new_features."""
    state, z, ids, zmask = _mid_run(P=300)
    assoc, is_new = jrbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)
    want = jkernels.fs1_observe_tpu(state, z, slot, matched,
                                    jnp.asarray(R), interpret=True)
    want = jrbpf.add_new_features(want, z, ids, is_new, jnp.asarray(R))
    _, *batch = _update_inputs(P=300)
    m, o = np.asarray(batch[2]), np.asarray(batch[4])
    assert m.any() and o.any() and not (m | o).all()
    xv, logw, lm, lm_P, *rest = _update_args(state, *batch)
    tkernels.observe(xv, logw, lm, lm_P, *rest)      # CPU: the twin
    np.testing.assert_allclose(logw.numpy(), np.asarray(want.logw), **TOL)
    np.testing.assert_allclose(lm.numpy(), np.asarray(want.lm), **TOL)
    np.testing.assert_allclose(lm_P.numpy(), np.asarray(want.lm_P), **TOL)


def _observe_call_at_slots(state, slot, z, matched):
    """JAX's K2 on the planes gathered at ``slot``: (dlogw [P], updated
    planes [5, K, P])."""
    gathered = jrbpf.gather_landmarks(state, slot)
    dlogw, *planes = jkernels._observe_call(
        state.xv, *gathered, z, matched, jnp.asarray(R), interpret=True)
    return np.asarray(dlogw)[0], np.stack([np.asarray(p) for p in planes])


def _twin_from_zero_weights(state, batch):
    """K2's twin with logw = 0, so that logw comes back as the weight
    delta: (dlogw [P], lm [2, L, P], lm_P [3, L, P]) as numpy."""
    xv, logw, lm, lm_P, *rest = _update_args(state, *batch)
    logw.zero_()
    tkernels.observe_plain(xv, logw, lm, lm_P, *rest)
    return logw.numpy(), lm.numpy(), lm_P.numpy()


def test_k2_twin_weight_and_matched_slots_match_observe_call():
    """The weight delta and the matched slots' planes of K2's twin
    against _observe_call (interpret mode) on the gathered planes."""
    state, z, slot, matched, slot_new, ok = _update_inputs(P=300)
    dlogw, planes = _observe_call_at_slots(state, slot, z, matched)
    got_w, lm, lm_P = _twin_from_zero_weights(
        state, (z, slot, matched, slot_new, ok))
    np.testing.assert_allclose(got_w, dlogw, **TOL)
    got = np.concatenate([lm, lm_P])
    for k in np.flatnonzero(np.asarray(matched)):
        np.testing.assert_allclose(got[:, int(slot[k])], planes[:, k],
                                   **TOL, err_msg=f"k={k}")


def test_k2_twin_keeps_the_first_update_of_a_shared_slot():
    """Two matched observations of one landmark: its slot takes the
    first one's update, and both updates and both weight terms come
    from the old values, as K2 on the card computes them."""
    state, z, slot, matched, slot_new, ok = _update_inputs(P=300)
    k0, k1 = np.flatnonzero(np.asarray(matched))[:2]
    freed = int(slot[k1])
    slot = slot.at[k1].set(slot[k0])
    dlogw, planes = _observe_call_at_slots(state, slot, z, matched)
    got_w, lm, lm_P = _twin_from_zero_weights(
        state, (z, slot, matched, slot_new, ok))
    np.testing.assert_allclose(got_w, dlogw, **TOL)
    got = np.concatenate([lm, lm_P])
    np.testing.assert_allclose(got[:, int(slot[k0])], planes[:, k0], **TOL)
    assert not np.allclose(planes[:, k0], planes[:, k1])
    old = np.concatenate([np.asarray(state.lm), np.asarray(state.lm_P)])
    np.testing.assert_array_equal(got[:, freed], old[:, freed])


@pytest.mark.parametrize("inputs", [
    dict(),
    dict(P=256, L=64, n_map=96, seed=12, run=_wide_run),
], ids=["mid-run", "wide-batch"])
def test_k4_twin_matches_fs1_update_tpu(inputs):
    state, z, slot, matched, slot_new, ok = _update_inputs(**inputs)
    assert bool(np.asarray(matched).any()) and bool(np.asarray(ok).any())
    assert not bool(np.asarray(matched | ok).all())
    want = jkernels.fs1_update_tpu(state, z, slot, matched, slot_new, ok,
                                   jnp.asarray(R), interpret=True)
    xv, logw, lm, lm_P, *rest = _update_args(state, z, slot, matched,
                                             slot_new, ok)
    lm0, lmP0 = lm.clone(), lm_P.clone()
    tkernels.fused_update_plain(xv, logw, lm, lm_P, *rest)
    np.testing.assert_allclose(logw.numpy(), np.asarray(want.logw), **TOL)
    np.testing.assert_allclose(lm.numpy(), np.asarray(want.lm), **TOL)
    np.testing.assert_allclose(lm_P.numpy(), np.asarray(want.lm_P), **TOL)
    # In place: the slots no observation touched keep their values.
    touched = set(np.asarray(slot)[np.asarray(matched)]) | set(
        np.asarray(slot_new)[np.asarray(ok)])
    keep = [s for s in range(lm.shape[1]) if s not in touched]
    assert torch.equal(lm[:, keep], lm0[:, keep])
    assert torch.equal(lm_P[:, keep], lmP0[:, keep])


def test_g1_twin_matches_sorted_gather_multi():
    P = 1024
    arrays = _gather_arrays(P)
    rng = np.random.default_rng(8)
    for idx in (np.sort(rng.integers(0, P, P)), np.zeros(P),
                rng.integers(0, P, P)):
        idx = idx.astype(np.int32)
        want = jgather.sorted_gather_multi(
            [jnp.asarray(a) for a in arrays], jnp.asarray(idx),
            interpret=True)
        got = tgather.sorted_gather_multi_plain(
            [_t(a) for a in arrays], _t(idx))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_g2_twin_matches_bounds_gather_multi():
    P = 1024
    arrays = _gather_arrays(P, seed=9)
    S = _bounds(P)
    want = jgather.bounds_gather_multi([jnp.asarray(a) for a in arrays],
                                       jnp.asarray(S), interpret=True)
    got = tgather.bounds_gather_multi_plain([_t(a) for a in arrays], _t(S))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# CPU dispatch and the build
# ---------------------------------------------------------------------------

def test_cpu_wrappers_run_the_twins_and_launch_nothing():
    tk.reset_launch_counts()
    state, *batch = _update_inputs(P=40, L=16, seed=1)
    a1 = _update_args(state, *batch)
    a2 = _update_args(state, *batch)
    tk.observe(*a1)
    tkernels.observe_plain(*a2)
    for g, w in zip(a1[:4], a2[:4]):
        assert torch.equal(g, w)

    state, *batch = _update_inputs(P=64, L=16)
    a1 = _update_args(state, *batch)
    a2 = _update_args(state, *batch)
    tk.fused_update(*a1)
    tkernels.fused_update_plain(*a2)
    for g, w in zip(a1[:4], a2[:4]):
        assert torch.equal(g, w)

    arrays = [_t(a) for a in _gather_arrays(512)]
    idx = _t(np.sort(np.random.default_rng(0).integers(0, 512, 512))
             .astype(np.int32))
    S = _t(_bounds(512))
    for g, w in zip(tk.sorted_gather_multi(arrays, idx),
                    tgather.sorted_gather_multi_plain(arrays, idx)):
        assert torch.equal(g, w)
    for g, w in zip(tk.bounds_gather_multi(arrays, S),
                    tgather.bounds_gather_multi_plain(arrays, S)):
        assert torch.equal(g, w)
    assert tk.launch_counts() == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                                  "K5": 0, "K6": 0, "K6b": 0, "G1": 0,
                                  "G2": 0}


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_library(build_dir=tmp_path)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_library(nvcc=str(tmp_path / "no-such-nvcc"),
                            build_dir=tmp_path)


def test_build_raises_with_compiler_output(tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'planes.cuh(1): error: boom' >&2\n"
                    "exit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    with pytest.raises(build.KernelBuildError, match="(?s)exit 3.*boom"):
        build.build_library(nvcc=str(fake), build_dir=tmp_path / "b")
    assert not any((tmp_path / "b").glob("*.so"))


def test_build_hash_covers_every_source():
    names = {p.name for p in build.CSRC_DIR.glob("*.cu*")}
    assert {"planes.cuh", "philox.cuh", "bounds.cuh", "observe.cu",
            "fused_update.cu",
            "gather.cu", "resample_update.cu", "predict.cu", "refine.cu",
            "jacobians.cu"} <= names
    assert [p.name for p in build.sources()] == sorted(
        n for n in names if n.endswith(".cu"))
    assert len(build.source_hash()) == 16


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its twin on the same inputs
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k2_kernel_matches_twin_on_card(cuda):
    """K2 within TOL of its twin and bit-equal to K4 on distinct slots;
    on a slot that two matched observations share, within TOL of its
    twin (K4 is not expected to match there)."""
    state, z, slot, matched, slot_new, ok = _update_inputs(P=1000, L=16)
    k0, k1 = np.flatnonzero(np.asarray(matched))[:2]
    for sl in (slot, slot.at[k1].set(slot[k0])):
        batch = (z, sl, matched, slot_new, ok)
        a_k2, a_twin, a_k4 = (_update_args(state, *batch, device=cuda)
                              for _ in range(3))
        before = tk.observe.launches
        tk.observe(*a_k2)
        assert tk.observe.launches == before + 1
        tkernels.observe_plain(*a_twin)
        tk.fused_update(*a_k4)
        torch.cuda.synchronize()
        for g, w, f in zip(a_k2[1:4], a_twin[1:4], a_k4[1:4]):
            torch.testing.assert_close(g, w, **TOL)
            if sl is slot:
                assert torch.equal(g, f)


@pytest.mark.cuda
def test_k4_kernel_matches_twin_on_card(cuda):
    state, *batch = _update_inputs(P=1000, L=16)
    a1 = _update_args(state, *batch, device=cuda)
    a2 = _update_args(state, *batch, device=cuda)
    tk.fused_update(*a1)
    tkernels.fused_update_plain(*a2)
    for g, w in zip(a1[:4], a2[:4]):
        torch.testing.assert_close(g, w, **TOL)


# A particle count for each of K4's thread maps: 4 threads per particle
# with a partial block (P = 1000), then 1; each P odd, so that no row of
# a plane starts on a 16-byte edge but the first.
K4_EDGE_P = (1000, 140_003)
# Matched counts at K4's edges, from (chunk, round) at P as the library
# reports them (round: threads per particle x chunk), with no new
# observation among them so that the counts fall on those edges.
K4_EDGES = {
    "none-matched": (lambda c, r: 0, 20), "one": (lambda c, r: 1, 0),
    "chunk": (lambda c, r: c, 0), "chunk+1": (lambda c, r: c + 1, 0),
    "round-1": (lambda c, r: r - 1, 0), "round": (lambda c, r: r, 0),
    "round+1": (lambda c, r: r + 1, 0), "mixed": (lambda c, r: 40, 20),
    "all-matched": (lambda c, r: 96, 0), "all-masked": (lambda c, r: 0, 0),
}


def _by_slot_batch(P, K, n_match, n_new, L=160, live=120, seed=3):
    """numpy inputs of K4 and K2: a landmark state of L slots, ``live``
    of them mapped, and a by-slot batch of K observations in a shuffled
    order: n_match matched on distinct live slots, n_new new (slots
    live, live + 1, ... in k order), the rest masked."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    truth = rng.uniform(-25, 25, size=(L, 2)).astype(f32)
    lm = truth.T[:, :, None] + f32(0.2) * rng.standard_normal((2, L, P), f32)
    lm_P = np.zeros((3, L, P), f32)
    lm_P[:, :live] = np.array([0.05, 0.01, 0.04], f32)[:, None, None]
    kind = rng.permutation(np.repeat([0, 1, 2], [n_match, n_new,
                                                 K - n_match - n_new]))
    matched, ok = kind == 0, kind == 1
    slot = rng.integers(0, live, K)
    slot[matched] = rng.choice(live, n_match, replace=False)
    slot_new = live + np.cumsum(ok) - ok
    d = truth[np.where(ok, slot_new, slot)] + 0.05 * rng.normal(size=(K, 2))
    z = np.column_stack([np.hypot(d[:, 0], d[:, 1]),
                         np.arctan2(d[:, 1], d[:, 0])])
    return dict(xv=f32(0.1) * rng.standard_normal((3, P), f32),
                logw=rng.standard_normal(P, f32), lm=lm, lm_P=lm_P,
                z=z.astype(f32), slot=slot.astype(np.int32), matched=matched,
                slot_new=slot_new.astype(np.int32), ok=ok)


def _by_slot_args(b, device):
    return (_t(b["xv"], device), _t(b["logw"], device), _t(b["lm"], device),
            _t(b["lm_P"], device), _t(b["z"], device), _t(b["slot"], device),
            _t(b["matched"], device), _t(b["slot_new"], device),
            _t(b["ok"], device), R)


@pytest.mark.cuda
@pytest.mark.parametrize("P", K4_EDGE_P)
@pytest.mark.parametrize("edge", list(K4_EDGES))
def test_k4_kernel_edges_on_card(cuda, P, edge):
    """K4 at K = 96 on each thread map, at matched counts around its
    chunk and its rounds: within TOL of its twin, and bit-equal to K2 on
    the same inputs (distinct slots: K2 keeps the old K4's operation
    order and k-ordered sum). All masked, nothing moves."""
    threads, chunk = tkernels.fused_update_map(P)
    count, n_new = K4_EDGES[edge]
    n_match = count(chunk, threads * chunk)
    b = _by_slot_batch(P, 96, n_match, n_new)
    a_k4, a_twin, a_k2 = (_by_slot_args(b, cuda) for _ in range(3))
    before = tk.fused_update.launches
    tk.fused_update(*a_k4)
    assert tk.fused_update.launches == before + 1
    tkernels.fused_update_plain(*a_twin)
    tk.observe(*a_k2)
    torch.cuda.synchronize()
    for g, w, o in zip(a_k4[1:4], a_twin[1:4], a_k2[1:4]):
        torch.testing.assert_close(g, w, **TOL)
        assert torch.equal(g, o)
    if n_match + n_new == 0:
        for g, w in zip(a_k4[1:4], _by_slot_args(b, cuda)[1:4]):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("P", K4_EDGE_P)
def test_k4_kernel_walks_a_repeated_slot_in_order(cuda, P):
    """Outside K4's contract: two matched observations of one slot, and
    two new ones aimed at one slot. K4 then walks the observations in k
    order, as one launch per observation does: the planes bit for bit;
    the weight within TOL (those launches add each term to logw on its
    own, K4 adds their sum)."""
    b = _by_slot_batch(P, 96, 40, 20)
    m, n = np.flatnonzero(b["matched"]), np.flatnonzero(b["ok"])
    b["slot"][m[1]] = b["slot"][m[0]]
    b["slot_new"][n[1]] = b["slot_new"][n[0]]
    got, want = _by_slot_args(b, cuda), _by_slot_args(b, cuda)
    tk.fused_update(*got)
    xv, logw, lm, lm_P, z, slot, matched, slot_new, ok, _ = want
    for k in range(96):
        tk.fused_update(xv, logw, lm, lm_P, z[k:k + 1], slot[k:k + 1],
                        matched[k:k + 1], slot_new[k:k + 1], ok[k:k + 1], R)
    torch.cuda.synchronize()
    assert torch.equal(got[2], lm) and torch.equal(got[3], lm_P)
    torch.testing.assert_close(got[1], logw, **TOL)


@pytest.mark.cuda
def test_gather_kernels_bit_exact_on_card(cuda):
    P = 2048
    arrays = [_t(a, cuda) for a in _gather_arrays(P, L=8)]
    idx = _t(np.sort(np.random.default_rng(1).integers(0, P, 700))
             .astype(np.int32), cuda)
    S = _t(_bounds(P), cuda)
    for g, w in zip(tk.sorted_gather_multi(arrays, idx),
                    tgather.sorted_gather_multi_plain(arrays, idx)):
        assert torch.equal(g, w)
    for g, w in zip(tk.bounds_gather_multi(arrays, S),
                    tgather.bounds_gather_multi_plain(arrays, S)):
        assert torch.equal(g, w)
