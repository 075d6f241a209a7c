"""Published peaks of the cards the benchmark reads rooflines against
(NVIDIA's data sheets; dense rates, at the card's full power limit)."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # SXM5
}


def hbm_bytes_per_s(kind: str):
    """The memory bandwidth of the card ``kind``, or None if unknown."""
    return HBM_BYTES_PER_S.get(kind)
