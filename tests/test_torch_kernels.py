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


def _observe_inputs(P=300, K=5, seed=0):
    rng = np.random.default_rng(seed)
    xv = rng.normal(size=(3, P)).astype(np.float32)
    lmx = (xv[0] + rng.normal(size=(K, P)) * 5 + 2).astype(np.float32)
    lmy = (xv[1] + rng.normal(size=(K, P)) * 5 + 1).astype(np.float32)
    A = rng.normal(size=(K, P)).astype(np.float32) * 0.3
    B = rng.normal(size=(K, P)).astype(np.float32) * 0.3
    planes = [lmx, lmy, A * A + 0.05, 0.3 * A * B, B * B + 0.05]
    z = np.column_stack([rng.uniform(3, 8, K),
                         rng.uniform(-0.5, 0.5, K)]).astype(np.float32)
    matched = np.arange(K) % 3 != 1
    return xv, planes, z, matched


def _update_inputs(P=256, L=16, n_map=24, seed=11):
    """A JAX ParticleState with 10 live slots, and an observation batch
    with matched, new (two of them), and masked entries; plus the
    bookkeeping fs1_update derives from it."""
    rng = np.random.default_rng(seed)
    table = -np.ones(n_map, np.int32)
    table[2:12] = np.arange(10)
    lm_P = np.zeros((3, L, P), np.float32)
    lm_P[0], lm_P[2] = 0.1, 0.1
    lm_P[1] = 0.01
    state = jinit(P, L, n_map)._replace(
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
    xv, planes, z, matched = _observe_inputs(P=300, K=5)
    want = jkernels._observe_call(
        *map(jnp.asarray, (xv, *planes, z, matched)), jnp.asarray(R),
        interpret=True)
    got = tkernels.observe_plain(_t(xv), *map(_t, planes), _t(z),
                                 _t(matched), R)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0])[0],
                               **TOL)
    for g, w, name in zip(got[1:], want[1:],
                          ("nx", "ny", "np00", "np01", "np11")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    # Unmatched observations pass through bit for bit.
    un = ~matched
    np.testing.assert_array_equal(got[1].numpy()[un], planes[0][un])


def test_k4_twin_matches_fs1_update_tpu():
    state, z, slot, matched, slot_new, ok = _update_inputs()
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
    xv, planes, z, matched = _observe_inputs(P=40, K=4, seed=1)
    args = (_t(xv), *map(_t, planes), _t(z), _t(matched), R)
    for g, w in zip(tk.observe(*args), tkernels.observe_plain(*args)):
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
    assert tk.launch_counts() == {"K2": 0, "K4": 0, "G1": 0, "G2": 0}


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
    assert {"planes.cuh", "observe.cu", "fused_update.cu",
            "gather.cu"} <= names
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
    xv, planes, z, matched = _observe_inputs(P=1000, K=15, seed=2)
    args = (_t(xv, cuda), *[_t(p, cuda) for p in planes], _t(z, cuda),
            _t(matched, cuda), R)
    before = tk.observe.launches
    got = tk.observe(*args)
    assert tk.observe.launches == before + 1
    for g, w in zip(got, tkernels.observe_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
def test_k4_kernel_matches_twin_on_card(cuda):
    state, *batch = _update_inputs(P=1000, L=16)
    a1 = _update_args(state, *batch, device=cuda)
    a2 = _update_args(state, *batch, device=cuda)
    tk.fused_update(*a1)
    tkernels.fused_update_plain(*a2)
    for g, w in zip(a1[:4], a2[:4]):
        torch.testing.assert_close(g, w, **TOL)


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
