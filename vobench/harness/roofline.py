"""The yardstick of the depth stage: the work SGBM as an algorithm needs at
a cell's shapes, and the least time an H100 could take for it.

The count is of the algorithm, not of any implementation, so it reads the
same whatever kernels run the stage. Per pixel: the stereo pair read once
(two uint8 images), the x16 disparity (int16) and its valid mask (one byte)
written once. Per pixel and disparity, operations of one element each:

- the Birchfield-Tomasi cost: two three-way envelopes compared against the
  other image (2 subtractions and 2 maxima each side) and their minimum: 9;
- the block's box sum, separable: 2 (block - 1) additions;
- each aggregation path: the neighbours' minimum, + P1, the minimum with
  the previous cost and with min + P2, + the cost, - the previous minimum,
  and the running minimum over disparities for the next pixel: 7;
- the sum of the paths: paths - 1 additions;
- winner-takes-all (1 comparison), the uniqueness test (1 multiply, 1
  comparison) and the right view's minimum for the left-right check (1).

The peaks are NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, the rate at the full
700 W. A multiply-add counts two there; each operation above counts one,
so the share is an upper bound on what the card could reach.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def sgbm_work(height: int, width: int, disparities: int, block: int,
              paths: int) -> tuple[float, float]:
    """(operations, bytes) of one frame's SGBM."""
    per = 9 + 2 * (block - 1) + 7 * paths + (paths - 1) + 1 + 2 + 1
    px = height * width
    return float(per * px * disparities), float(px * (2 + 2 + 1))


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work, and which of the two peaks binds."""
    t_ops, t_bytes = ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
