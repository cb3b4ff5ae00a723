"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM, and
the operations and bytes of the work the benchmark measures, counted from
shapes. Nothing here is read from the program.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity) at its
700 W power limit: 67 TFLOP/s of float32 outside the tensor cores, 67
TFLOP/s of float64 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

#: float32 FLOP/s outside the tensor cores.
PEAK_F32_FLOPS = 67e12
#: float64 FLOP/s on the tensor cores (the same figure, so one serves both).
PEAK_F64_TENSOR_FLOPS = 67e12
#: HBM bytes per second.
PEAK_BYTES_PER_S = 3.35e12


def unit_gram_flops(n: int, A: int, B: int, M: int) -> float:
    """The unit gram's work: the cross term u v^T, 2 A B M multiply-adds
    per member of a batch of n, whatever the kernel does to compute it."""
    return 2.0 * n * A * B * M


def unit_gram_bytes(n: int, A: int, B: int, M: int, shared: bool) -> float:
    """float32 bytes the unit gram must move: each input read once (one
    operand where u is v) and E written once."""
    inputs = n * (A * M + (0 if shared else B * M))
    return 4.0 * (inputs + n * A * B)


def unit_gram_least_seconds(n: int, A: int, B: int, M: int, shared: bool) -> float:
    """The least time the card could take for one launch: the larger of the
    work at the float32 peak and the bytes at the HBM bandwidth."""
    return max(unit_gram_flops(n, A, B, M) / PEAK_F32_FLOPS,
               unit_gram_bytes(n, A, B, M, shared) / PEAK_BYTES_PER_S)


def lml_valgrad_flops(N: int, M: int) -> float:
    """Model FLOPs of one exact LML value and gradient of one GP of N rows
    and M inputs, whatever the engine does: the Cholesky factor (N^3 / 3),
    K^-1 (2 N^3 / 3), the gram's cross term (2 N^2 M) and the lengthscale
    gradient's contraction (2 N^2 M)."""
    return N ** 3 / 3.0 + 2.0 * N ** 3 / 3.0 + 4.0 * N * N * M


def mfu_percent(flops: float, seconds: float, peak: float = PEAK_F32_FLOPS) -> float:
    """The share of the peak, in %, that ``flops`` in ``seconds`` is."""
    return 100.0 * flops / (seconds * peak)
