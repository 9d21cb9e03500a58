"""The card's peaks and the work of the port's kernels, counted from what
their inputs need.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
(``chip_smoke.py`` uses the same two): FP32 outside the tensor cores and
HBM3 bandwidth.  A roofline share is the least time the card could take
(the larger of operations over the FP32 peak and bytes over the bandwidth)
over the kernel's measured device time; the share is stated against these
published peaks, with the card's power limit printed beside it.

Work, whatever implements the call:
- K1 (exact nearest neighbour of every source among the targets): 8
  operations per (valid source, valid target) pair (3 differences, 3
  products, 2 sums: the squared distance; the running minimum's compare
  is counted in neither), bytes of the valid sources and targets read
  once (12 B each) and of each source's index and distance written (8 B).
- K2 (ball moments of every query over the targets within the radius): 24
  operations per neighbour pair (8 for its squared distance, 16 for the
  count, first and second moments), bytes of the valid queries and targets
  read once (12 B each) and of each query's 10 moments written (40 B).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def k1_work(valid_src, valid_tgt) -> tuple[float, float]:
    """(operations, bytes) of one K1 launch over pairs of clouds with these
    valid counts."""
    ops = sum(8.0 * s * t for s, t in zip(valid_src, valid_tgt))
    return ops, sum(20.0 * s + 12.0 * t for s, t in zip(valid_src, valid_tgt))


def k2_work(valid_query, valid_tgt, neighbours) -> tuple[float, float]:
    return (24.0 * float(neighbours),
            sum(52.0 * q + 12.0 * t for q, t in zip(valid_query, valid_tgt)))


def bound_seconds(ops: float, n_bytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / FP32_FLOPS, n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def share(ops: float, n_bytes: float, seconds: float):
    """(roofline share in %, what bounds it), or None without device time."""
    if seconds <= 0 or ops <= 0:
        return None
    t, by = bound_seconds(ops, n_bytes)
    return 100.0 * t / seconds, by
