"""The least time the card could take for one launch of K1 or K2.

Copied from ``chip_smoke.py`` (commit fef00ad: ``k1_bound_ms``,
``k2_bound_ms``, ``K1_OPS_PER_ROW``, ``PEAK_SCALAR_OPS``), with one
change: the memory rate is the published peak of the H100 SXM (NVIDIA's
data sheet, 3.35 TB/s at its 700 W limit), not the rate worked out from
the card's attributes, so a roofline share is stated against one fixed
yardstick. The result line carries the card's power limit beside it.
"""

from __future__ import annotations

#: bytes per second, H100 SXM data sheet
PEAK_BYTES_PER_S = 3.35e12
#: the H100 SXM data sheet's rate outside the tensor cores (67 T/s of
#: float32); K1 is scalar integer work there
PEAK_SCALAR_OPS = 67e12
#: the int32 compares, selects and adds K1 does per row, counted from
#: tpu_cc_manager_torch/csrc/fleet_tick.cu (histogram selects included)
K1_OPS_PER_ROW = 64
#: K1's launches and K2's, by their kernel names in the port's csrc/
K1_KERNELS = ("tick_init", "tick_rows", "tick_epilogue")
K2_KERNELS = ("delta_scatter_kernel",)


def k1_bound_ms(n: int, pb: int, slots: int,
                rate: float = PEAK_BYTES_PER_S) -> float:
    """K1 over ``n`` rows of the int32[8, n] block, ``pb`` pool slots and
    ``slots`` slice slots: every column read once, the seven per-row
    masks and the slot and pool aggregates written once; the larger of
    that over ``rate`` and the row operations over the scalar peak."""
    read = 4 * 8 * n + 4 * pb
    written = 7 * n + 2 * slots + 4 * (2 * 6 + 6 * pb)
    t_bytes = (read + written) / rate
    t_ops = n * K1_OPS_PER_ROW / PEAK_SCALAR_OPS
    return 1e3 * max(t_bytes, t_ops)


def k2_bound_ms(kb: int, live: int, rate: float = PEAK_BYTES_PER_S) -> float:
    """K2 reads every index once, and only a live slot's 8 values, which
    it writes once: 4 bytes per slot and 64 per live slot."""
    return 1e3 * (4 * kb + 2 * 4 * 8 * live) / rate
