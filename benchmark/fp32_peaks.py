"""Published float32 rates of the cards the benchmark reads compute
rooflines against (NVIDIA's data sheets: dense float32 outside the
tensor cores, the rate a product runs at with TF32 off; at the card's
full power limit)."""

FP32_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,     # SXM5
}


def fp32_flops(kind: str):
    """The float32 rate of the card ``kind``, or None if unknown."""
    return FP32_FLOPS.get(kind)
