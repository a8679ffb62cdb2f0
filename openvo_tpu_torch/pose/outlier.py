"""Median-residual outlier rejection (one pass), PyTorch port of
``openvo_tpu/pose/outlier.py``: fit a rigid transform on the current
inliers, and keep the points whose relative residual is strictly below
``outlier_threshold + median(residuals)``."""

from __future__ import annotations

import torch

from openvo_tpu_torch.pose.kabsch import kabsch, residuals_relative


def masked_median(values, mask):
    """``np.median`` over the rows of 1-D ``values`` where ``mask`` holds:
    the mean of the two middle values for an even count, NaN if any of
    them is NaN (an inlier threshold of NaN then keeps no point)."""
    v = torch.sort(torch.where(mask, values, float("inf"))).values
    n = mask.to(torch.int64).sum()
    lo = torch.clamp_min((n - 1) // 2, 0)
    hi = torch.clamp_min(n // 2, 0)
    med = 0.5 * (v[lo] + v[hi])
    has_nan = (torch.isnan(values) & mask).any()
    return torch.where(has_nan, float("nan"), med)


def outlier_filter(src, dst, mask, outlier_threshold):
    """One round of fit and relative-residual gating over the rows where
    ``mask`` holds; returns the refined mask (a subset of ``mask``). The
    fit uses every such row; the gate is a strict ``<``."""
    T = kabsch(src, dst, mask)
    err = residuals_relative(T, src, dst, mask)
    return mask & (err < outlier_threshold + masked_median(err, mask))
