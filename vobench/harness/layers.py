"""Per-layer timings on the card, taken after the window: the camera's
depth entry (``StereoCamera.compute_3d_fn``, the function the odometer's
step calls: rectify, SGBM, reproject, crop) and ORB's entry (``ops/orb.detect_and_compute``), each alone, each
captured as the main path runs it, on the cell's own frames, timed by CUDA
events over many calls."""

from __future__ import annotations

import torch

CALLS = 48


def _event_ms(fn, inputs, calls: int = CALLS) -> float:
    """Mean ms a call of ``fn`` over ``inputs`` taken in turn, by CUDA
    events; two calls of each input first (capture and warm-up)."""
    for x in inputs + inputs:
        fn(*x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(calls):
        fn(*inputs[k % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_layers(prog, calls_inputs, frames_per_call: int) -> dict:
    """``calls_inputs``: the (left, right) host tensors of a few of the
    cell's calls, each as the entry takes them (one pair, a rig's instant or
    a chunk). Returns ms a call of each entry and the frames a call."""
    from openvo_tpu_torch._graph import capture
    from openvo_tpu_torch.ops.orb import detect_and_compute

    cam, cfg = prog.camera, prog.config
    fn = cam.compute_3d_fn(False, cfg.preprocessed_frames)
    depth = capture(lambda _, l, r: ((), *fn(l, r)), cam.device)
    depth_ms = _event_ms(lambda l, r: depth((), l, r), calls_inputs)
    orb_inputs = []
    for l, r in calls_inputs:
        _, _, disp, img = depth((), l, r)
        disp, img = disp.clone(), img.clone()
        mask = ((disp >= cfg.min_valid_disparity)
                & (disp <= cfg.max_valid_disparity)).to(torch.uint8)
        orb_inputs.append((img, mask))

    def orb(_, img, mask):
        out = detect_and_compute(img, mask, cfg.orb)
        return ((), *(out[k] for k in sorted(out)))

    step = capture(orb, cam.device)
    orb_ms = _event_ms(lambda img, mask: step((), img, mask), orb_inputs)
    return {"depth_ms": depth_ms, "orb_ms": orb_ms,
            "frames_per_call": frames_per_call}
