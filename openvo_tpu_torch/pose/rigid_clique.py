"""Rigid-body-consistency inlier filter (greedy max-clique), PyTorch port of
``openvo_tpu/pose/rigid_clique.py``.

1. delta[i, j] = | ||p_i - p_j|| - ||p'_i - p'_j|| |;
2. consistency[i, j] = delta[i, j] < rigidity_threshold, for valid i, j;
3. seed the clique at the point with the most consistencies, then add, one
   at a time, the point not yet chosen with the most consistencies among
   those consistent with every member, until no such point remains (or n
   points were added).

JAX runs step 3 as a ``lax.while_loop``. Here it runs on the device in
batches of ``CHECK_EVERY`` iterations between host checks: once the loop's
condition fails, ``torch.where`` freezes the state, so a batch that runs
past the end changes nothing (without the freeze, an iteration with no
candidate would pick index 0, the argmax of zeros). The host syncs of a
call are counted on ``rigid_body_filter.syncs``.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch.pose.kabsch import row_norm

CHECK_EVERY = 32   # loop iterations between host checks


def _pair_distances(p):
    return row_norm(p[:, None, :] - p[None, :, :])


def rigid_body_filter(prev_pts, pts, mask, rigidity_threshold):
    """(N,) int32 0/1 membership of the greedy max-clique of mutually
    distance-consistent correspondences; 0 for rows where ``mask`` is
    False, and all 0 when no row is valid. A valid row with NaN
    coordinates is consistent with nothing, itself included."""
    n = pts.shape[0]
    dev = pts.device
    p = torch.where(mask[:, None], pts, 0.0)
    q = torch.where(mask[:, None], prev_pts, 0.0)
    delta = torch.abs(_pair_distances(p) - _pair_distances(q))
    cons = (delta < rigidity_threshold) & mask[:, None] & mask[None, :]
    num = cons.to(torch.int32).sum(0)
    ar = torch.arange(n, device=dev)
    # ties go to the first maximum, as jnp.argmax
    seed = torch.argmax(num).reshape(1)
    clique = (ar == seed).to(torch.int32)
    compatible = cons.index_select(0, seed)[0].to(torch.int32)
    it = torch.zeros((), dtype=torch.int32, device=dev)

    def running(clique, compatible, it):
        # JAX's condition: candidates = compatible - clique may hold -1
        return ((compatible - clique).sum() > 0) & (it < n)

    while True:
        for _ in range(CHECK_EVERY):
            go = running(clique, compatible, it)
            sel = torch.argmax(num * (compatible - clique))
            grown = torch.where(ar == sel, 1, clique).to(torch.int32)
            # consistency @ clique (an int matmul has no CUDA kernel)
            members = (cons & (grown > 0)).sum(1)
            compat = (members >= grown.sum()).to(torch.int32)
            clique = torch.where(go, grown, clique)
            compatible = torch.where(go, compat, compatible)
            it = it + go.to(torch.int32)
        rigid_body_filter.syncs += 1
        if not bool(running(clique, compatible, it)):
            break
    return torch.where(mask.any(), clique, 0).to(torch.int32)


rigid_body_filter.syncs = 0
