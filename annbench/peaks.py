"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit) and the roofline
bound of a kernel's work."""

HBM_BYTES_S = 3.35e12
TF32_OPS_S = 495e12  # the highest rate that can give float32-accurate products
F32_OPS_S = 67e12
INT8_OPS_S = 1979e12


def bound_s(nbytes: float, ops: float, ops_rate: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over ``ops_rate``."""
    return max(nbytes / HBM_BYTES_S, ops / ops_rate)


def flat_scan_bound_s(B: int, N: int, d: int, k: int) -> float:
    """An exact float32 top-k of B queries over N points: 2 B N d
    operations at the TF32 rate, and the points, queries and the (id,
    distance) lists each moved once."""
    return bound_s(N * d * 4 + B * d * 4 + B * k * 8, 2.0 * B * N * d, TF32_OPS_S)
