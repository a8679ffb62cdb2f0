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
candidate would pick index 0, the argmax of zeros). Over a batch of point
clouds (the cameras of a rig) each member freezes on its own condition and
the host check asks whether any member still runs. The host syncs of a
call are counted on ``rigid_body_filter.syncs``.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch.pose.kabsch import row_norm

CHECK_EVERY = 32   # loop iterations between host checks


def _pair_distances(p):
    return row_norm(p[..., :, None, :] - p[..., None, :, :])


def rigid_body_filter(prev_pts, pts, mask, rigidity_threshold):
    """(N,) int32 0/1 membership of the greedy max-clique of mutually
    distance-consistent correspondences; 0 for rows where ``mask`` is
    False, and all 0 when no row is valid. A valid row with NaN
    coordinates is consistent with nothing, itself included.

    (B, N, 3) clouds with a (B, N) mask give (B, N), as ``jax.vmap`` of
    the JAX package's filter: the loop steps every member together, each
    frozen once its own condition fails, with one host check a batch of
    steps for the whole batch. The distances are elementwise FMA chains,
    the counts integer sums and the argmax per member, so each member gets
    its own call's clique."""
    n = pts.shape[-2]
    dev = pts.device
    p = torch.where(mask[..., None], pts, 0.0)
    q = torch.where(mask[..., None], prev_pts, 0.0)
    delta = torch.abs(_pair_distances(p) - _pair_distances(q))
    cons = ((delta < rigidity_threshold) & mask[..., :, None]
            & mask[..., None, :])
    num = cons.to(torch.int32).sum(-2)
    ar = torch.arange(n, device=dev)
    # ties go to the first maximum, as jnp.argmax
    seed = torch.argmax(num, -1, keepdim=True)
    clique = (ar == seed).to(torch.int32)
    compatible = torch.take_along_dim(cons, seed[..., None],
                                      -2)[..., 0, :].to(torch.int32)
    it = torch.zeros(seed.shape, dtype=torch.int32, device=dev)

    def running(clique, compatible, it):
        # JAX's condition: candidates = compatible - clique may hold -1
        return ((compatible - clique).sum(-1, keepdim=True) > 0) & (it < n)

    while True:
        for _ in range(CHECK_EVERY):
            go = running(clique, compatible, it)
            sel = torch.argmax(num * (compatible - clique), -1, keepdim=True)
            grown = torch.where(ar == sel, 1, clique).to(torch.int32)
            # consistency @ clique (an int matmul has no CUDA kernel)
            members = (cons & (grown[..., None, :] > 0)).sum(-1)
            compat = (members >= grown.sum(-1, keepdim=True)).to(torch.int32)
            clique = torch.where(go, grown, clique)
            compatible = torch.where(go, compat, compatible)
            it = it + go.to(torch.int32)
        rigid_body_filter.syncs += 1
        if not bool(running(clique, compatible, it).any()):
            break
    return torch.where(mask.any(-1, keepdim=True), clique,
                       0).to(torch.int32)


rigid_body_filter.syncs = 0
