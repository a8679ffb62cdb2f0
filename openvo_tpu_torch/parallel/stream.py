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
them (the float32 cost volume), and the speckle filter's labelling kernel
H7, so a chunk pays their launches once instead of once a frame
(``models/stereo_odometer.py``).

The trajectory is the frame-at-a-time odometer's: the batched ``extract``
gives each frame the single-frame call's disparity, keypoints and
descriptors bit for bit, and the state machine consumes the same features
in the same order.

JAX runs each chunk as one program: ``extract`` under ``vmap``, then the
state machine under ``lax.scan`` (``openvo_tpu/parallel/stream.py:52-72``).
Here a chunk is one function too, the batched ``extract`` and the state
machine unrolled over the chunk's frames, and on the card it is captured
once per chunk size as a CUDA graph and replayed
(``openvo_tpu_torch/_graph.py``): the stream reads nothing on the host,
at every SGBM and filter configuration (the speckle filter's labelling and
the rigid clique's loop are the kernels H7 and H8 there).
"""

from __future__ import annotations

import torch

from openvo_tpu_torch import trace
from openvo_tpu_torch._graph import capture, capture_enabled, mark
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
    chunk's features.

    On the card (unless capture is disabled) each chunk replays a CUDA
    graph captured once per chunk size (``stream.graphs``, by size;
    ``stream.captured`` says how the last call ran), and the state
    returned is the graph's static buffers, valid until the next call
    with that size, as JAX's donated state.
    ``stream.skip_codes`` holds each frame's skip code of the last call.
    A call is traced as ``ovo.stream`` (``openvo_tpu_torch/trace.py``); a
    chunk's graph marks ``depth`` and ``orb`` once and ``match``, ``pose``
    and ``state`` once a frame."""
    fns = make_pipeline_fns(camera, cfg, color)
    extract, step_feats = fns["extract"], fns["step_feats"]
    dev = camera.device
    graphs = {}

    def run_chunk(state, lefts, rights):
        """One chunk: (state, (n, H, W) pairs) -> (state', ok (n,),
        c_T_w (n, 4, 4), skip code (n,))."""
        mark("start")
        feats = extract(lefts, rights)
        oks, poses, codes = [], [], []
        for i in range(lefts.shape[0]):
            state, ok, _ = step_feats(state,
                                      FrameFeatures(*(x[i] for x in feats)))
            oks.append(ok)
            poses.append(state.c_T_w)
            codes.append(state.skip_code)
        return state, torch.stack(oks), torch.stack(poses), torch.stack(codes)

    def stream(state, lefts, rights):
        with trace.span("ovo.stream"):
            with trace.span("ovo.upload"):
                lefts = torch.as_tensor(lefts, device=dev)
                rights = torch.as_tensor(rights, device=dev)
            trace.settle(dev)
            b = lefts.shape[0]
            size = b if chunk is None or chunk >= b else chunk
            if b % size:
                raise ValueError(f"frame count {b} not divisible by "
                                 f"{chunk=}")
            stream.captured = dev.type == "cuda" and capture_enabled()
            if stream.captured and size not in graphs:
                graphs[size] = capture(run_chunk)
            outs = []
            for start in range(0, b, size):
                cut = slice(start, start + size)
                if stream.captured:
                    state, *out = graphs[size](state, lefts[cut], rights[cut])
                    with trace.span("ovo.unpack"):
                        out = [x.clone() for x in out]
                else:
                    with trace.span("ovo.launch"):
                        state, *out = run_chunk(state, lefts[cut],
                                                rights[cut])
                outs.append(out)
            with trace.span("ovo.unpack"):
                ok, pose, stream.skip_codes = (torch.cat(x)
                                               for x in zip(*outs))
            return state, (ok, pose)

    stream.graphs = graphs
    stream.captured = None
    stream.skip_codes = None
    return stream
