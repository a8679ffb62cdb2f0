"""Batch-extraction streaming VO, PyTorch port of
``openvo_tpu/parallel/stream.py``: the state-free part of each frame's step
(rectify, SGBM, reproject, ORB: ``extract``) runs batched over a chunk of
frames, then the odometer's state machine (match against the last accepted
frame, Kabsch, gates, pose chain) steps frame by frame over the extracted
features.

JAX maps ``extract`` with ``jax.vmap``, which gives each Pallas kernel a
batch grid axis. Here ``extract`` takes the (B, H, W) chunk itself, at
every SGBM configuration: each SGBM kernel (H1, H2, H3 on the int16 path;
H5, H2, H3 over block13's float32 volume) and the descriptor kernel H4
launches once for the chunk, and so do the plain PyTorch stages around
them (the float32 cost volume, the speckle filter's labelling loop), so a
chunk pays their launches and host syncs once instead of once a frame
(``models/stereo_odometer.py``).

The trajectory is the frame-at-a-time odometer's: the batched ``extract``
gives each frame the single-frame call's disparity, keypoints and
descriptors bit for bit, and the state machine consumes the same features
in the same order.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch.config import OdometerConfig
from openvo_tpu_torch.models.stereo_odometer import (FrameFeatures,
                                                     make_pipeline_fns)


def make_stream_fn(camera, cfg: OdometerConfig, color: bool = False,
                   chunk: int | None = None):
    """Build ``stream(state, lefts, rights) -> (state', (ok, c_T_w))``.

    ``lefts``/``rights`` are (B, H, W[, 3]) frame stacks (tensors or numpy
    arrays, moved to the camera's device); ``ok`` is (B,) bool and ``c_T_w``
    (B, 4, 4), the pose after each frame. The frames are extracted batched,
    ``chunk`` at a time (all B at once without it: ``chunk`` bounds the
    batched stages' memory, and B must be a multiple of it), then the state
    machine, with the reference's skip/fallback semantics, steps over each
    chunk's features, one host sync a frame."""
    fns = make_pipeline_fns(camera, cfg, color)
    extract, step_feats = fns["extract"], fns["step_feats"]
    dev = camera.device

    def stream(state, lefts, rights):
        lefts = torch.as_tensor(lefts, device=dev)
        rights = torch.as_tensor(rights, device=dev)
        b = lefts.shape[0]
        size = b if chunk is None or chunk >= b else chunk
        if b % size:
            raise ValueError(f"frame count {b} not divisible by {chunk=}")
        oks, poses = [], []
        for start in range(0, b, size):
            feats = extract(lefts[start:start + size],
                            rights[start:start + size])
            for i in range(size):
                state, ok, _ = step_feats(
                    state, FrameFeatures(*(x[i] for x in feats)))
                oks.append(ok)
                poses.append(state.c_T_w)
        return state, (torch.stack(oks), torch.stack(poses))

    return stream
