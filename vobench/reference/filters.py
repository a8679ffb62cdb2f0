"""The odometer's two correspondence filters, of the plain reference: the
rigid clique (the greedy max-clique of mutually distance-consistent
matches) and one outlier pass (fit, then keep the matches whose relative
residual is strictly below the threshold plus the median residual).

Frozen copy of the semantics of ``openvo_tpu_torch/pose/rigid_clique.py``
and ``pose/outlier.py`` of the commit that defined the benchmark; the
clique's growth is written as the plain greedy loop, one pick at a time on
the host, and imports nothing of the program.
"""

from __future__ import annotations

import torch

from vobench.reference.geometry import kabsch_fit_plain
from vobench.reference.image import fma


def row_norm(v):
    """Euclidean norm of each row of (..., n) float32 ``v``: a chain of
    fused multiply-adds over the components, then sqrt."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = fma(v[..., i], v[..., i], acc)
    return torch.sqrt(acc)


def consistency(prev_pts, pts, mask, threshold: float):
    """(N, N) bool: the pairs of valid rows whose distance changed by less
    than ``threshold`` (a NaN row is consistent with nothing, itself
    included)."""
    p = torch.where(mask[:, None], pts, 0.0)
    q = torch.where(mask[:, None], prev_pts, 0.0)
    dp = row_norm(p[:, None, :] - p[None, :, :])
    dq = row_norm(q[:, None, :] - q[None, :, :])
    return ((dp - dq).abs() < threshold) & mask[:, None] & mask[None, :]


def rigid_clique(prev_pts, pts, mask, threshold: float):
    """(N,) bool membership of the greedy clique: seed at the row with the
    most consistent partners (the first such), then repeatedly add the
    candidate, a row consistent with every member and not one, with the
    most partners (the first such), until none is left (at most N picks).
    No valid row: no member. The growth stops where the candidates, counted
    as consistent-with-every-member minus member, sum to zero or less, as
    the original's condition."""
    n = mask.shape[0]
    if not bool(mask.any()):
        return torch.zeros(n, dtype=torch.bool, device=mask.device)
    cons = consistency(prev_pts, pts, mask, threshold).cpu()
    num = cons.sum(0, dtype=torch.int64)
    seed = int(torch.argmax(num))
    clique = torch.zeros(n, dtype=torch.int64)
    clique[seed] = 1
    compatible = cons[seed].to(torch.int64)
    for _ in range(n):
        cand = compatible - clique
        if int(cand.sum()) <= 0:
            break
        pick = int(torch.argmax(num * cand))
        clique[pick] = 1
        # consistent with every member: the last set, and with the pick
        compatible = compatible * cons[:, pick]
    return clique.bool().to(mask.device)


def residuals_relative(T, src, dst, mask):
    """||h_dst - T h_src|| / ||h_dst|| over homogeneous 4-vectors, the four
    products of ``T h_src`` added in ascending order without fusing; inf
    where ``mask`` is False."""
    ones = torch.ones(src.shape[:-1] + (1,), dtype=src.dtype,
                      device=src.device)
    hs = torch.cat([src, ones], -1)
    hd = torch.cat([dst, ones], -1)
    pred = hs[..., 0, None] * T[None, :, 0]
    for k in range(1, 4):
        pred = pred + hs[..., k, None] * T[None, :, k]
    err = row_norm(hd - pred) / row_norm(hd)
    return torch.where(mask, err, float("inf"))


def masked_median(values, mask):
    """``np.median`` of ``values`` where ``mask`` holds (the mean of the two
    middle values for an even count), NaN if any of them is NaN."""
    v = values[mask]
    if bool(torch.isnan(v).any()):
        return torch.tensor(float("nan"), device=values.device)
    v = torch.sort(v).values
    n = v.numel()
    return 0.5 * (v[max((n - 1) // 2, 0)] + v[max(n // 2, 0)])


def outlier_pass(src, dst, mask, threshold: float):
    """The mask kept by one round of fit and relative-residual gating over
    the rows where ``mask`` holds (a strict ``<``)."""
    T = kabsch_fit_plain(src[None], dst[None], mask[None])[0]
    err = residuals_relative(T, src, dst, mask)
    return mask & (err < threshold + masked_median(err, mask))
