"""Median-residual outlier rejection (one pass), PyTorch port of
``openvo_tpu/pose/outlier.py``: fit a rigid transform on the current
inliers, and keep the points whose relative residual is strictly below
``outlier_threshold + median(residuals)``."""

from __future__ import annotations

import torch

from openvo_tpu_torch.pose.kabsch import kabsch, residuals_relative


def masked_median(values, mask):
    """``np.median`` over the entries of ``values`` where ``mask`` holds,
    along the last axis (a batch of rows gives one median a row): the mean
    of the two middle values for an even count, NaN if any of them is NaN
    (an inlier threshold of NaN then keeps no point)."""
    v = torch.sort(torch.where(mask, values, float("inf")), -1).values
    n = mask.to(torch.int64).sum(-1, keepdim=True)
    lo = torch.clamp_min((n - 1) // 2, 0)
    hi = torch.clamp_min(n // 2, 0)
    med = 0.5 * (torch.take_along_dim(v, lo, -1)
                 + torch.take_along_dim(v, hi, -1))[..., 0]
    has_nan = (torch.isnan(values) & mask).any(-1)
    return torch.where(has_nan, float("nan"), med)


def outlier_filter(src, dst, mask, outlier_threshold):
    """One round of fit and relative-residual gating over the rows where
    ``mask`` holds; returns the refined mask (a subset of ``mask``). The
    fit uses every such row; the gate is a strict ``<``. (B, N, 3) clouds
    with a (B, N) mask give (B, N), each member its own call's mask."""
    T = kabsch(src, dst, mask)
    err = residuals_relative(T, src, dst, mask)
    thresh = outlier_threshold + masked_median(err, mask)
    return mask & (err < thresh[..., None])
