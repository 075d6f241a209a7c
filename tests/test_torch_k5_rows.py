"""K5's live and empty rows (csrc/resample_update.cu, the twin
``kernels.resample_update_plain``): rows [n_end, L) are stored as +0.0
and never read, rows [0, n_end) are G2's gather followed by K4; the
host's rule for K5's slot chunks; the empty-row counter
``resample_update.rows`` and the benchmark's reader of it. On the card,
K5 against G2 + K4 with the empty rows zeroed, bit for bit, at the
shapes of ``config5-full10k.mapped`` and ``config5-1m.dense``."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops.kernels import gather as kg
from slam_tpu_torch.ops.kernels import kernels as kk
from slam_tpu_torch.ops.kernels.selfcheck import (
    R,
    k5_bounds,
    k5_composed,
    update_inputs,
)

ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132


def _plus_zero(t) -> bool:
    """Every element +0.0 (a -0.0 or a NaN fails)."""
    return bool((t == 0).all()) and not bool(torch.signbit(t).any())


def _cpu_inputs(fill, live=20, n_new=5, L=64, P=1024, K=16, n_map=96,
                seed=4):
    """A state with ``live`` live slots and a batch (8 matched, ``n_new``
    new, the rest masked) at P particles, the rows at and past n set to
    ``fill`` ("noise" keeps update_inputs' noise in lm and adds it to
    lm_P), and fired offspring bounds."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    state, batch = update_inputs("cpu", rng, g, P, L, K, n_map=n_map,
                                 live=live, n_match=8, n_new=n_new,
                                 past_capacity=live + n_new > L)
    if fill == "nan":
        state.lm[:, live:] = math.nan
        state.lm_P[:, live:] = math.nan
    else:
        state.lm_P[:, live:] = torch.randn((3, L - live, P), generator=g)
    return state, batch, k5_bounds("cpu", rng, g, P, "fired")


@pytest.mark.parametrize("fill,live,n_end", [
    ("noise", 20, 25), ("nan", 20, 25), ("noise", 62, 64),
    ("nan", 62, 64)], ids=["noise", "nan", "noise-past-capacity",
                           "nan-past-capacity"])
def test_twin_zeroes_the_empty_rows_and_keeps_the_live_ones(fill, live,
                                                            n_end):
    """The twin's rows [n_end, L) are +0.0 whatever the input held past
    n; its rows [0, n_end) and the weights are G2's twin followed by
    K4's twin, bit for bit. Past capacity (62 live of 64 slots, 5 new)
    the new features that find no slot are dropped and n_end is L."""
    state, batch, S = _cpu_inputs(fill, live=live)
    L, P = state.lm.shape[1:]
    lw_k, lw_r = state.logw.clone(), state.logw.clone()
    lm, lm_P = kk.resample_update_plain(state.xv, lw_k, state.lm,
                                        state.lm_P, S, *batch, R, state.n)
    lm_g, lmP_g = kg.bounds_gather_multi_plain(
        [state.lm.reshape(2 * L, P), state.lm_P.reshape(3 * L, P)], S)
    lm_g, lmP_g = lm_g.reshape(2, L, P), lmP_g.reshape(3, L, P)
    kk.fused_update_plain(state.xv, lw_r, lm_g, lmP_g, *batch, R)
    assert int(kk.live_end(state.n, *batch[1:], L)) == n_end
    assert torch.equal(lw_k, lw_r)
    assert torch.equal(lm[:, :n_end], lm_g[:, :n_end])
    assert torch.equal(lm_P[:, :n_end], lmP_g[:, :n_end])
    assert _plus_zero(lm[:, n_end:]) and _plus_zero(lm_P[:, n_end:])
    if n_end < L:
        assert not _plus_zero(lm_g[:, n_end:])   # the fill reached G2
    assert not bool(torch.isnan(lm[:, :n_end]).any())


def _batch(L, slot, matched, slot_new, ok):
    i32, b = torch.int32, torch.bool
    return (torch.tensor(slot, dtype=i32), torch.tensor(matched, dtype=b),
            torch.tensor(slot_new, dtype=i32), torch.tensor(ok, dtype=b))


@pytest.mark.parametrize("n,batch,want", [
    (10, ([1, 4, 0], [True, True, False], [10, 10, 11],
          [False, True, True]), 12),                       # n + new
    (0, ([0], [False], [0], [False]), 0),                  # all empty
    (15, ([3, 0, 0], [True, False, False], [15, 15, 16],
          [False, True, False]), 16),                      # at L
    (15, ([3, 0, 0], [True, False, False], [15, 15, 16],
          [False, True, True]), 16),                       # one dropped
    (4, ([9, 0], [True, False], [4, 5], [False, False]), 10),  # past n
    (20, ([], [], [], []), 16),                            # n past L
    (3, ([], [], [], []), 3),                              # K = 0
], ids=["new", "none", "capacity", "dropped", "matched-past-n",
        "n-past-L", "no-observation"])
def test_live_end(n, batch, want):
    """n_end: n plus the new features that find a slot, or one past the
    last slot an observation writes where that lies further, at most L
    (L = 16)."""
    got = kk.live_end(torch.tensor(n, dtype=torch.int32),
                      *_batch(16, *batch), 16)
    assert got.shape == () and int(got) == want


@pytest.mark.parametrize("P,L,sms", [
    (2 ** 20, 192, H100_SMS), (32_768, 10_000, H100_SMS),
    (32_768, 10_000, 114), (2 ** 17, 200, H100_SMS),
    (8_192, 40, H100_SMS), (100, 16, H100_SMS)])
def test_chunk_rule(P, L, sms):
    """One chunk where the column tiles alone give every SM 4 blocks
    (the dense cell's 2,048 tiles); at least 4 blocks an SM otherwise,
    unless that would leave a chunk fewer than 32 slots. A function of
    the shapes and the SM count alone, no card needed."""
    chunks = kk.resample_update_chunks(P, L, sms)
    tiles = -(-P // kk.K5_TILE)
    assert chunks >= 1 and chunks <= max(1, -(-L // 32))
    if tiles >= 4 * sms:
        assert chunks == 1
    elif chunks < -(-L // 32):
        assert tiles * chunks >= 4 * sms
    if (P, L) == (2 ** 20, 192):
        assert chunks == 1
    if (P, L) == (32_768, 10_000):
        assert tiles * chunks >= 4 * sms


@pytest.mark.parametrize("start", [None, (7, 9)], ids=["none", "counted"])
def test_the_twin_leaves_the_row_counter_alone(monkeypatch, start):
    """On the CPU the wrapper runs the twin and ``resample_update.rows``
    keeps what it held: it counts kernel launches only."""
    held = None if start is None else torch.tensor(start, dtype=torch.int64)
    monkeypatch.setattr(kk.resample_update, "rows", held)
    state, batch, S = _cpu_inputs("noise")
    kk.resample_update(state.xv, state.logw, state.lm, state.lm_P, S,
                       *batch, R, state.n)
    assert kk.resample_update.rows is held
    if held is not None:
        assert held.tolist() == list(start)


def _reader():
    from benchmark.run import load_module
    return load_module(ROOT / "benchmark" / "metrics"
                       / "k5_zero_row_share.py")


@pytest.mark.parametrize("rows,want", [
    (None, None), ((0, 0), None), ((8_531, 10_000), 85.31),
    ((1_344, 19_200), 7.0)], ids=["no-counter", "no-launch", "full10k",
                                  "dense"])
def test_zero_row_share_reader(monkeypatch, rows, want):
    """k5_zero_row_share: 100 sum(L - n_end) / sum L from the counter;
    None with no counter or no launch."""
    monkeypatch.setattr(kk.resample_update, "rows", None if rows is None
                        else torch.tensor(rows, dtype=torch.int64))
    got = _reader().read({})
    assert got == pytest.approx(want) if want is not None else got is None


def test_zero_row_share_reader_without_the_counter(monkeypatch):
    """A program whose K5 wrapper has no ``rows`` (the parent's) reads
    None, and raises nothing."""
    monkeypatch.delattr(kk.resample_update, "rows")
    assert _reader().read({}) is None


def test_the_filter_passes_its_live_count(monkeypatch):
    """``fs1_observe`` hands K5 the state's own n, the 0-d int32 device
    tensor, so the kernel reads it by pointer with no host read."""
    from slam_tpu_torch.models import fastslam1

    seen = []
    inner = fastslam1.landmark_update

    def spy(*args, **kw):
        seen.append(kw.get("n"))
        return inner(*args, **kw)
    monkeypatch.setattr(fastslam1, "landmark_update", spy)
    rng = np.random.default_rng(0)
    state, batch = update_inputs("cpu", rng, torch.Generator(), 512, 32, 8,
                                 n_map=48, live=10, n_match=4, n_new=2)
    z, slot, matched, _, ok = batch
    ids = torch.arange(8, dtype=torch.int32)
    S = torch.arange(1, 513, dtype=torch.int32)
    out = fastslam1.fs1_observe(state, z, ids, slot, matched, ok, R, S=S)
    assert seen == [state.n] and int(out.n) == 12
    assert _plus_zero(out.lm[:, 12:]) and _plus_zero(out.lm_P[:, 12:])
    with pytest.raises(ValueError, match="live count"):
        kk.landmark_update(state.xv, state.logw, state.lm, state.lm_P, z,
                           slot, matched, batch[3], ok, R, S=S)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _card_case(dev, P, L, live, K=96, n_match=70, n_new=20, seed=7):
    """update_inputs at P particles, L slots, ``live`` of them live (the
    rows past it noise in lm, zero in lm_P; new features past capacity
    left flagged for the kernel to drop), and fired offspring bounds."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_match = min(n_match, live)
    state, batch = update_inputs(
        dev, rng, g, P, L, K, n_map=max(live + n_new, 2 * n_new),
        live=live, n_match=n_match, n_new=n_new,
        past_capacity=live + n_new > L)
    return state, batch, k5_bounds(dev, rng, g, P, "fired")


def _check_on_card(dev, P, L, live):
    """K5 against G2 + K4 with the empty rows zeroed, bit for bit on the
    whole planes and the weights; the row counter's (L - n_end, L)."""
    state, batch, S = _card_case(dev, P, L, live)
    logw = torch.randn(P, generator=torch.Generator(device=dev)
                       .manual_seed(1), device=dev)
    lw_k, lw_r = logw.clone(), logw.clone()
    n_end = int(kk.live_end(state.n, *batch[1:], L))
    kk.resample_update(state.xv, lw_k, state.lm, state.lm_P, S, *batch, R,
                       state.n)   # the counter made, if it was not
    torch.cuda.synchronize()
    before = kk.resample_update.rows.clone()
    lw_k = logw.clone()
    got = kk.resample_update(state.xv, lw_k, state.lm, state.lm_P, S,
                             *batch, R, state.n)
    torch.cuda.synchronize()
    assert (kk.resample_update.rows - before).tolist() == [L - n_end, L]
    want = k5_composed(state, batch, S, lw_r)
    torch.cuda.synchronize()
    assert torch.equal(lw_k, lw_r)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
        assert _plus_zero(a[:, n_end:])
    return n_end


@pytest.mark.cuda
@pytest.mark.parametrize("live", [0, 1_469, 9_990, 10_000])
def test_k5_on_card_at_full_capacity(cuda, live):
    """config5-full10k.mapped's shapes: P = 32,768, L = 10,000, K = 96,
    from no live slot, the cell's start, new features running past the
    last slot, and every slot live. The chunks cut the live rows (a
    chunk boundary inside them, the last at n_end)."""
    P, L = 32_768, 10_000
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunks = kk.resample_update_chunks(P, L, sms)
    assert chunks >= 2
    n_end = _check_on_card(cuda, P, L, live)
    assert n_end == min(L, live + 20)
    if live == 1_469:
        assert n_end > chunks
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_k5_on_card_at_the_dense_shape(cuda):
    """config5-1m.dense's shapes: P = 2^20, L = 192, 110 live slots, one
    chunk."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kk.resample_update_chunks(2 ** 20, 192, sms) == 1
    assert _check_on_card(cuda, 2 ** 20, 192, 110) == 130
    torch.cuda.empty_cache()
