"""Frames sharded across the ranks of a ``torch.distributed`` group, PyTorch
port of ``openvo_tpu/parallel/sharding.py``: the throughput-oriented batch
API, pure frame-to-frame tracking (a failed fit contributes the identity),
while the sequential ``StereoOdometer`` keeps the reference's full
skip/fallback semantics.

- The (B, H, W) frame stream is split along the frame axis: rank r holds
  frames [r*B/n, (r+1)*B/n) and extracts their features batched (each
  kernel launched once for the block).
- Each rank fits the relative pose of every consecutive pair of its block
  with the batched ``attempt``. The one cross-rank dependency, the last
  frame of the previous rank's block, travels to the next rank point to
  point, as JAX's ring ``ppermute`` (whose wrap-around message, to rank 0,
  only feeds global frame 0, which is the identity).
- The relative poses and flags are all-gathered in rank order and composed
  into the trajectory by a log-depth scan over 4x4 matmuls
  (:func:`compose_trajectory`).

JAX's ``make_mesh`` (``sharding.py:37``) has no counterpart: the ranks of
a ``torch.distributed`` group (:func:`make_sharded_trajectory_fn`'s
``group``, the default group if None) take the place of the mesh's devices.

Messages go through ``parallel/tiling._Transport``: where the backend is
gloo and the tensors lie on a card, each is staged through host memory, so
ranks can share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import torch

from openvo_tpu_torch.config import OdometerConfig
from openvo_tpu_torch.models.stereo_odometer import (FrameFeatures,
                                                     make_pipeline_fns)
from openvo_tpu_torch.parallel.tiling import _Transport


def compose_trajectory(T_rel):
    """Cumulative pose chain P_i = T_i @ T_{i-1} @ ... @ T_0 of (B, 4, 4)
    relative transforms, by a log-depth (Hillis-Steele) scan: ceil(log2 B)
    batched matmuls instead of the reference's B - 1 sequential
    left-multiplications (stereo_odometer.py:138)."""
    P = T_rel
    k = 1
    while k < P.shape[0]:
        P = torch.cat([P[:k], P[k:] @ P[:-k]])
        k *= 2
    return P


def _pair_poses(attempt, prev: FrameFeatures, feats: FrameFeatures,
                first: bool):
    """(T (b, 4, 4), ok (b,)) of each pair (prev[i], feats[i]), fitted
    batched with no motion history (skipped 0, code 0); with ``first`` the
    pair of row 0 is global frame 0's, the identity. A failed fit is the
    identity."""
    b = feats.kp_valid.shape[0]
    zeros = torch.zeros((b,), dtype=torch.int32,
                        device=feats.kp_valid.device)
    T, ok, _, _ = attempt(prev, feats, zeros, zeros)
    if first:
        ok = torch.cat([torch.ones_like(ok[:1]), ok[1:]])
        T = torch.cat([torch.eye(4, dtype=T.dtype, device=T.device)[None],
                       T[1:]])
    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    return torch.where(ok[:, None, None], T, eye), ok


def make_relative_pose_fn(camera, cfg: OdometerConfig, color: bool = False):
    """(framesL (B,H,W), framesR) -> (T_rel (B,4,4), ok (B,)) in one process
    on the camera's device. T_rel[0] = I; T_rel[i] maps frame i-1 coords to
    frame i coords."""
    fns = make_pipeline_fns(camera, cfg, color)
    extract, attempt = fns["extract"], fns["attempt"]
    dev = camera.device

    def fn(frames_l, frames_r):
        feats = extract(torch.as_tensor(frames_l, device=dev),
                        torch.as_tensor(frames_r, device=dev))
        # frame 0 paired with itself: its row is set to the identity
        prev = FrameFeatures(*(torch.cat([x[:1], x[:-1]]) for x in feats))
        return _pair_poses(attempt, prev, feats, first=True)

    return fn


def _pass_last(feats: FrameFeatures, comm: _Transport) -> FrameFeatures:
    """Send this rank's last frame's features to the next rank and receive
    the previous rank's (rank 0 keeps its own first frame, a placeholder
    for global frame 0's pair). Even ranks send first, odd ranks receive
    first, so that no two ranks wait on each other."""
    r, n = comm.rank, comm.n
    # gloo carries no bool: the valid flags travel as uint8
    last = [x[-1].to(torch.uint8) if x.dtype == torch.bool else x[-1]
            for x in feats]
    recv = [x[0] for x in feats]

    def send():
        if r + 1 < n:
            for i, t in enumerate(last):
                comm.send(t, r + 1, tag=i)

    def receive():
        if r > 0:
            for i, t in enumerate(last):
                got = comm.recv(t.shape, t.dtype, r - 1, tag=i)
                recv[i] = got.to(feats[i].dtype)

    for part in ((send, receive) if r % 2 == 0 else (receive, send)):
        part()
    return FrameFeatures(*recv)


def make_sharded_trajectory_fn(camera, cfg: OdometerConfig, group=None,
                               color: bool = False):
    """Build ``fn(framesL (B,H,W), framesR) -> (c_T_w chain (B, 4, 4), ok
    (B,))`` for every rank of ``group`` (the default group if None) to call
    with the same frames: the rank extracts and fits its own block of B/n
    frames on the camera's device, and every rank returns the whole
    trajectory and flags, those of :func:`make_relative_pose_fn` and
    :func:`compose_trajectory` in one process. B must be a multiple of the
    group's size."""
    fns = make_pipeline_fns(camera, cfg, color)
    extract, attempt = fns["extract"], fns["attempt"]
    dev = camera.device
    comm = _Transport(group, dev)

    def fn(frames_l, frames_r):
        B = frames_l.shape[0]
        if B % comm.n:
            raise ValueError(f"frame count {B} not divisible by the group's "
                             f"{comm.n} ranks")
        b = B // comm.n
        block = slice(comm.rank * b, (comm.rank + 1) * b)
        feats = extract(torch.as_tensor(frames_l[block], device=dev),
                        torch.as_tensor(frames_r[block], device=dev))
        before = _pass_last(feats, comm)
        prev = FrameFeatures(*(torch.cat([p[None], x[:-1]])
                               for p, x in zip(before, feats)))
        T, ok = _pair_poses(attempt, prev, feats, first=comm.rank == 0)
        T_all = comm.all_gather(T).reshape(B, 4, 4)
        ok_all = comm.all_gather(ok.to(torch.uint8)).reshape(B).bool()
        return compose_trajectory(T_all), ok_all

    return fn
