"""Rigid-body-consistency inlier filter (greedy max-clique), PyTorch port of
``openvo_tpu/pose/rigid_clique.py``.

1. delta[i, j] = | ||p_i - p_j|| - ||p'_i - p'_j|| |;
2. consistency[i, j] = delta[i, j] < rigidity_threshold, for valid i, j;
3. seed the clique at the point with the most consistencies, then add, one
   at a time, the point not yet chosen with the most consistencies among
   those consistent with every member, until no such point remains (or n
   points were added).

Steps 1-2 are plain PyTorch (:func:`consistency`). JAX runs step 3 as a
``lax.while_loop``; here it is the operator ``openvo_torch::greedy_clique``:
on the card the kernel H8 (``ops/clique_cuda.py``, the loop in one launch,
one block a cloud, no host read), on the CPU its plain version
:func:`greedy_clique_plain`, and under ``make_fx``'s fake mode a node of
the traced graph.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch.ops import clique_cuda
from openvo_tpu_torch.pose.kabsch import row_norm

CHECK_EVERY = 32   # loop iterations between host checks (plain version)


def _pair_distances(p):
    return row_norm(p[..., :, None, :] - p[..., None, :, :])


def consistency(prev_pts, pts, mask, rigidity_threshold):
    """(cons, num) of (N, 3) clouds with an (N,) mask, or (B, N, 3) with
    (B, N): cons (..., N, N) bool, the pairs of valid rows whose distance
    changed by less than the threshold (a NaN row is consistent with
    nothing, itself included), and num (..., N) int32, its column sums."""
    p = torch.where(mask[..., None], pts, 0.0)
    q = torch.where(mask[..., None], prev_pts, 0.0)
    delta = torch.abs(_pair_distances(p) - _pair_distances(q))
    cons = ((delta < rigidity_threshold) & mask[..., :, None]
            & mask[..., None, :])
    return cons, cons.sum(-2, dtype=torch.int32)


def greedy_clique_plain(cons, num):
    """H8's plain version: JAX's loop on the device in batches of
    ``CHECK_EVERY`` iterations between host checks. Once the loop's
    condition fails, ``torch.where`` freezes the state, so a batch that
    runs past the end changes nothing (without the freeze, an iteration
    with no candidate would pick index 0, the argmax of zeros). Over a
    batch of clouds (the cameras of a rig) each member freezes on its own
    condition and the host check asks whether any member still runs. The
    host syncs are counted on ``rigid_body_filter.syncs``."""
    n = cons.shape[-1]
    dev = cons.device
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
    return clique


@torch.library.custom_op("openvo_torch::greedy_clique", mutates_args=(),
                         device_types="cpu")
def _greedy_clique(cons: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    return greedy_clique_plain(cons, num)


@_greedy_clique.register_kernel("cuda")
def _(cons, num):
    return clique_cuda.greedy_clique(cons.contiguous(), num.contiguous())


@_greedy_clique.register_fake
def _(cons, num):
    return num.new_empty(num.shape)


def rigid_body_filter(prev_pts, pts, mask, rigidity_threshold):
    """(N,) int32 0/1 membership of the greedy max-clique of mutually
    distance-consistent correspondences; 0 for rows where ``mask`` is
    False, and all 0 when no row is valid. A valid row with NaN
    coordinates is consistent with nothing, itself included.

    (B, N, 3) clouds with a (B, N) mask give (B, N), as ``jax.vmap`` of
    the JAX package's filter: each member runs its own loop (its own block
    of H8; frozen on its own condition in the plain version). The distances
    are elementwise FMA chains, the counts integer sums and the argmax per
    member, so each member gets its own call's clique."""
    cons, num = consistency(prev_pts, pts, mask, rigidity_threshold)
    clique = torch.ops.openvo_torch.greedy_clique(cons, num)
    return torch.where(mask.any(-1, keepdim=True), clique,
                       0).to(torch.int32)


rigid_body_filter.syncs = 0
