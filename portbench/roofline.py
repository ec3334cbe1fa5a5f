"""Peaks of the card and the least time a kernel's work can take.

The bound of a launch is the larger of the bytes it must move at the
card's memory rate and its float32 operations at the rate outside the
tensor cores (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit):
each input byte counted once a launch, each output byte once.  A share
of the roofline is that bound over the time the trace measured.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
F32 = I32 = 4


def padded(count: int) -> int:
    """The port's power-of-two bucket of at least 64 (nodes and
    constraints of a solve)."""
    return max(64, 1 << (int(count) - 1).bit_length())


def pcg_solve_bytes(nodes: int, constraints: int) -> int:
    """Bytes one ``pcg_solve`` launch reads and writes on a graph of
    ``nodes`` and ``constraints`` (padded as the solver pads them): begin
    and end [C]; the constraint blocks Baa, Bab, Bbb [C, 3, 3]; the block
    diagonal and its inverse [N, 3, 3]; lam; the free mask [N]; the
    right-hand side [N, 3]; the begin and end incidence lists (offsets
    [N + 1] and the live constraints); out, the step [N, 3] and the count
    of steps."""
    n, c = padded(nodes), padded(constraints)
    reads = (2 * c * I32 + 3 * c * 9 * F32 + 2 * n * 9 * F32 + F32
             + n * F32 + n * 3 * F32
             + 2 * (n + 1) * I32 + 2 * int(constraints) * I32)
    writes = n * 3 * F32 + I32
    return reads + writes


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)


def share(bound: float, measured_s: float):
    """Percent of the roofline, or None where nothing was measured."""
    if measured_s <= 0.0:
        return None
    return 100.0 * bound / measured_s
