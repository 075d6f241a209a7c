"""R1, the resample's offspring bounds in one launch
(``slam_tpu_torch.ops.kernels.bounds``), against its twin
``ops.resampling.offspring_bounds_plain``.

- On the CPU the wrapper is the twin and launches nothing, on every kind
  of ``selfcheck.bounds_inputs``: random weights, prefix sums that dip by
  an ulp at the twin's 1024-row edges and at R1's tile edges (and deeper
  at every third tile edge), all the weight on one particle, uniform
  weights, a prefix sum whose tail passes 1, and a first entry near 1.
  A dither given as a bare callable gives the bounds of its table.
- On the card R1 is bit-equal to the twin at P from 1 to 2^20 + 37, on
  the same kinds, and on the filter's weights after K5 at config #5's
  shapes; back-to-back launches at other P, and on another stream, find
  a clean workspace.

The JAX package's draws are held against R1's CPU path in
tests/test_torch_resampling.py.
"""

import numpy as np
import pytest
import torch

from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops import resampling as rs
from slam_tpu_torch.ops.kernels import bounds as kb
from slam_tpu_torch.ops.kernels import kernels as kk
from slam_tpu_torch.ops.kernels import selfcheck as sc

P_CPU = 3 * sc.R1_TILE + 777


@pytest.mark.parametrize("kind", sc.BOUNDS_KINDS)
def test_cpu_wrapper_is_the_twin(kind):
    g = torch.Generator().manual_seed(5)
    csum, U = sc.bounds_inputs("cpu", g, P_CPU, kind)
    tk.reset_launch_counts()
    got = kb.offspring_bounds(csum, P_CPU, U)
    want = rs.offspring_bounds_plain(csum, P_CPU, U)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(rs.offspring_bounds(csum, P_CPU, U), want)
    assert tk.launch_counts()["R1"] == 0
    assert torch.all(got[1:] >= got[:-1]) and int(got[-1]) == P_CPU


def test_inputs_dip_where_they_say():
    """The "dips" kind dips at every row edge and tile edge; "spike"
    makes tile 0's first bound the largest until the sum passes it."""
    g = torch.Generator().manual_seed(1)
    csum, _ = sc.bounds_inputs("cpu", g, P_CPU, "dips")
    edges = sorted({*range(sc.CUMSUM_ROW, P_CPU, sc.CUMSUM_ROW),
                    *range(sc.R1_TILE, P_CPU, sc.R1_TILE)})
    assert all(csum[e] < csum[e - 1] for e in edges)
    csum, U = sc.bounds_inputs("cpu", g, P_CPU, "spike")
    S = rs.offspring_bounds_plain(csum, P_CPU, U)
    held = int((S[1:] == S[0]).sum())
    assert held > 2 * sc.R1_TILE


def test_a_callable_dither_gives_its_tables_bounds():
    g = torch.Generator().manual_seed(2)
    csum, U = sc.bounds_inputs("cpu", g, P_CPU, "random")
    bare = lambda pos: U.table[pos]  # noqa: E731
    assert torch.equal(kb.dither_table(bare, P_CPU, csum.device), U.table)
    assert torch.equal(kb.dither_table(U, P_CPU, csum.device), U.table)
    assert torch.equal(kb.offspring_bounds(csum, P_CPU, bare),
                       kb.offspring_bounds(csum, P_CPU, U))


def test_uniform_from_generator_carries_its_table():
    g = torch.Generator().manual_seed(3)
    U = rs.uniform_from_generator(40, g)
    assert isinstance(U, rs.DitherTable) and U.table.shape == (40,)
    pos = torch.tensor([0, 39, 7])
    assert torch.equal(U(pos), U.table[pos])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 100, 1024, 1025, 4097, 2 ** 15, 2 ** 17,
                               2 ** 20, 2 ** 20 + 37])
def test_r1_bit_equal_to_twin_on_card(cuda, P):
    g = torch.Generator(device=cuda).manual_seed(P)
    before = tk.launch_counts()["R1"]
    sc.check_offspring_bounds(cuda, g, P)
    assert tk.launch_counts()["R1"] - before == 2 * len(sc.BOUNDS_KINDS)


@pytest.mark.cuda
def test_r1_on_filter_weights_after_k5_on_card(cuda):
    """The weights K5 leaves at config #5's shapes (P = 2^20, L = 192,
    K = 96) from a fired resample's bounds, then R1 on their prefix
    sum, bit-equal to the twin."""
    w = dict(sc.CONFIG5)
    L, K = w.pop("L"), w.pop("K")
    P = sc.P_LARGE
    g = torch.Generator(device=cuda).manual_seed(29)
    rng = np.random.default_rng(29)
    state, batch = sc.update_inputs(cuda, rng, g, P, L, K, **w)
    logw = torch.randn(P, generator=g, device=cuda)
    S = sc.k5_bounds(cuda, rng, g, P, "fired")
    kk.resample_update(state.xv, logw, state.lm, state.lm_P, S, *batch,
                       sc.R, state.n)
    csum = rs.cumulative_weights(rs.normalize_log_weights(logw))
    U = rs.uniform_from_generator(P, g, cuda)
    got = kb.offspring_bounds(csum, P, U)
    want = rs.offspring_bounds_plain(csum, P, U)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_r1_leaves_a_clean_workspace_on_card(cuda):
    """Launches back to back at growing and shrinking P, and on a second
    stream, each bit-equal to the twin: every launch finds its
    workspace's counters and status words zeroed."""
    g = torch.Generator(device=cuda).manual_seed(7)
    inputs = [sc.bounds_inputs(cuda, g, P, "dips")
              for P in (5000, 2 ** 17, 3000, 2 ** 17 + 1, 1)]
    wants = [rs.offspring_bounds_plain(c, c.shape[0], U) for c, U in inputs]
    gots = [kb.offspring_bounds(c, c.shape[0], U) for c, U in inputs * 3]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        gots += [kb.offspring_bounds(c, c.shape[0], U) for c, U in inputs]
    torch.cuda.synchronize()
    for i, got in enumerate(gots):
        assert torch.equal(got, wants[i % len(inputs)])
