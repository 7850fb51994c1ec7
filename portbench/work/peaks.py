"""Published peaks by the name ``torch.cuda.get_device_name`` gives: NVIDIA's
H100 SXM data sheet, dense rates without sparsity, at the full 700 W
power limit (a card set lower runs slower; the runs print its limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str):
    """The card's peaks, or None for a card not in the table."""
    return PEAKS.get(kind)
