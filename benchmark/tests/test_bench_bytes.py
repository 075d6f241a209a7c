"""The byte counts behind the kernels' roofline shares, by hand at config
#5's shapes, and the shares' arithmetic."""

from conftest import ROOT

from benchmark import run

P, L, K, T = 2 ** 20, 192, 96, 8


def metric(name):
    return run.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def test_k5_bytes_by_hand():
    k5 = metric("k5_roofline")
    planes = 5 * 192 * 1048576 * 4             # the new landmark planes
    assert planes == 4_026_531_840
    weights = 1048576 * 4                      # logw, written in place
    reads = (3 + 1 + 1) * 1048576 * 4 + 96 * 8 + 96 * 10
    assert k5.k5_bytes(P, L, K) == planes + weights + reads


def test_k6_bytes_by_hand():
    k6 = metric("k6_roofline")
    assert k6.k6_bytes(P, T) == 2 * 12_582_912 + 64 + 8
    assert abs(k6.k6_bytes(P, T) / 1e6 - 25.17) < 0.01


def test_roofline_share_arithmetic():
    k5 = metric("k5_roofline")
    seconds = k5.k5_bytes(P, L, K) / 3.35e12 * 2     # half the bound
    ctx = {"trace": {"ops": {"void fs1_resample_update_kernel<4>(...)":
                             (seconds * 10, 10)}},
           "device_kind": "NVIDIA H100 80GB HBM3",
           "shapes": {"P": P, "L": L, "K": K}}
    assert abs(k5.read(ctx) - 50.0) < 1e-9
    assert k5.read(dict(ctx, trace={"ops": {}})) is None
    assert k5.read(dict(ctx, device_kind="cpu")) is None
    assert k5.read(dict(ctx, trace=None)) is None
