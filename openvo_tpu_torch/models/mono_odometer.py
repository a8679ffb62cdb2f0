"""Monocular visual odometry by essential-matrix tracking, PyTorch port of
``openvo_tpu/models/mono_odometer.py``.

Per frame, on the state's device: ORB on the full frame (its descriptor
kernel H4), Hamming ratio matching against the last accepted frame,
5-point RANSAC for E (``pose/ransac.ransac_essential_5pt``) and
cheirality-based pose recovery. Monocular scale is unobservable: each
frame's translation is unit-norm, scaled by ``trans_scale``.

JAX splits a PRNG key every frame; here the state holds a
``torch.Generator`` on its device (seeded 0) that draws the frame's
(iters, 5) uniforms every frame, the first included, so the two chains
stay aligned frame for frame. A caller may pass the uniforms instead
(``update(..., u=...)``), for example JAX's own, to replay its samples.

The step reads nothing back to the host (its SVDs are the kernel H11 on the
card, ``pose/kabsch.svd``); ``update`` reads its stats once. JAX compiles
the step into one program with ``trans_scale`` a traced float32 input
(``openvo_tpu/models/mono_odometer.py:155-166``); on the card
``MonoOdometer.update`` replays it as one CUDA graph (``_graph.capture``),
one per input signature (the image's shape and type, and whether ``u`` is
given), with ``trans_scale`` a 0-d float32 input and the state's generator
registered with the graph, so a replay draws what the eager step draws.

The step places the device's stage marks (``_graph.mark``): ``start``
before the draw, ``orb`` after ORB (with the draw), ``match`` after the
ratio test and the normalisation, ``ransac`` after the five-point RANSAC
(sampling, null spaces, solver, MSAC and the refits), ``pose`` after
recoverPose, the gates and the composition; the capture adds ``state``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openvo_tpu_torch import trace
from openvo_tpu_torch._graph import capture, capture_enabled, mark
from openvo_tpu_torch.config import OdometerConfig
from openvo_tpu_torch.geometry.se3 import rt_to_T
from openvo_tpu_torch.ops._dispatch import target_device
from openvo_tpu_torch.ops.hamming import ratio_test_match
from openvo_tpu_torch.ops.orb import detect_and_compute
from openvo_tpu_torch.pose.ransac import (ransac_essential_5pt, recover_pose,
                                          uniforms)


class MonoFrame(NamedTuple):
    kp_xy: torch.Tensor     # (K, 2) float32
    desc: torch.Tensor      # (K, 32) uint8
    kp_valid: torch.Tensor  # (K,) bool


class MonoState(NamedTuple):
    cur: MonoFrame
    has_cur: torch.Tensor     # () bool
    c_T_w: torch.Tensor       # (4, 4) float32 world-in-camera
    skipped: torch.Tensor     # () int32
    generator: torch.Generator


def init_state(max_keypoints: int, device="cuda") -> MonoState:
    device = target_device(device)
    return MonoState(
        cur=MonoFrame(
            kp_xy=torch.zeros((max_keypoints, 2), dtype=torch.float32,
                              device=device),
            desc=torch.zeros((max_keypoints, 32), dtype=torch.uint8,
                             device=device),
            kp_valid=torch.zeros((max_keypoints,), dtype=torch.bool,
                                 device=device),
        ),
        has_cur=torch.tensor(False, device=device),
        c_T_w=torch.eye(4, dtype=torch.float32, device=device),
        skipped=torch.tensor(0, dtype=torch.int32, device=device),
        generator=torch.Generator(device=device).manual_seed(0),
    )


def state_from_jax_leaves(leaves, device="cuda") -> MonoState:
    """The port's state from the numpy leaves of a JAX ``MonoState``
    (``jax.tree_util.tree_flatten`` order: kp_xy, desc, kp_valid, has_cur,
    c_T_w, skipped, key). JAX's threefry key cannot seed a torch
    generator's chain, so the state's generator starts from 0."""
    device = target_device(device)
    if len(leaves) != 7:
        raise ValueError(f"expected 7 leaves, got {len(leaves)}")
    t = [torch.as_tensor(np.array(x), device=device) for x in leaves[:6]]
    return MonoState(MonoFrame(*t[:3]), *t[3:],
                     torch.Generator(device=device).manual_seed(0))


def ransac_samples(ransac_iters: int) -> int:
    """5-point samples a frame for ``ransac_iters``: each sample gives up
    to 10 candidate E's, so a quarter of the 8-point count."""
    return max(ransac_iters // 4, 16)


def make_step(K, cfg: OdometerConfig, ransac_iters: int = 256,
              inlier_px: float = 1.0, min_inliers: int = 15):
    """(state, img, trans_scale, u=None) -> (state', accept, stats). ``K``
    is the 3x3 intrinsic matrix; images are (H, W) grayscale;
    ``trans_scale`` a number or a 0-d float32 tensor; ``u`` the frame's
    (iters, 5) uniforms, drawn from the state's generator when None."""
    K = np.asarray(K, dtype=np.float64)
    fx, fy, cx, cy = (float(v) for v in (K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    # Sampson threshold in normalized coords ~ (px / f)^2
    thresh = float((inlier_px / ((fx + fy) * 0.5)) ** 2)
    iters = ransac_samples(ransac_iters)

    def normalize(xy):
        return torch.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy],
                           dim=1)

    def step(state: MonoState, img, trans_scale, u=None):
        dev = state.c_T_w.device
        mark("start")
        # drawn before anything else, every frame, as JAX splits its key
        u = uniforms(state.generator if u is None else u, (iters, 5), dev)
        feats = detect_and_compute(img, None, cfg.orb)
        frame = MonoFrame(feats["xy"], feats["desc"], feats["valid"])
        mark("orb")
        n_kps = frame.kp_valid.to(torch.int32).sum()
        first = ~state.has_cur

        train_idx, mok = ratio_test_match(state.cur.desc, frame.desc,
                                          cfg.match_threshold,
                                          state.cur.kp_valid, frame.kp_valid)
        x1 = normalize(state.cur.kp_xy)
        x2 = normalize(frame.kp_xy[train_idx.to(torch.int64)])
        n_matches = mok.to(torch.int32).sum()
        mark("match")

        E, inl, n_inl = ransac_essential_5pt(x1, x2, mok, u, iters=iters,
                                             inlier_threshold=thresh)
        mark("ransac")
        R, t, support = recover_pose(E, x1, x2, inl)
        n_support = support.to(torch.int32).sum()

        few_kps = n_kps < cfg.min_matches
        few_matches = n_matches < cfg.min_matches
        few_inl = n_inl < min_inliers
        few_sup = n_support < min_inliers // 2
        ok = ~first & ~few_matches & ~few_inl & ~few_sup
        # the failure cause (as StereoOdometer.skip_cause): the first
        # failing check in keypoints, matches, inliers, support order
        code = torch.zeros((), dtype=torch.int32, device=dev)
        code = torch.where(few_sup, 4, code)
        code = torch.where(few_inl, 3, code)
        code = torch.where(few_matches, 2, code)
        code = torch.where(few_kps, 1, code)
        code = torch.where(first | ok, 0, code)
        # T maps prev-camera coords to new-camera coords
        T = rt_to_T(R.to(torch.float32), (t * trans_scale).to(torch.float32))
        c_T_w = torch.where(ok, T @ state.c_T_w, state.c_T_w)

        accept = first | ok
        new_state = MonoState(
            cur=MonoFrame(*(torch.where(accept, a, b)
                            for a, b in zip(frame, state.cur))),
            has_cur=state.has_cur | accept,
            c_T_w=c_T_w,
            skipped=torch.where(accept, 0, state.skipped + 1).to(torch.int32),
            generator=state.generator,
        )
        stats = {"n_kps": n_kps, "n_matches": n_matches, "n_inliers": n_inl,
                 "n_support": n_support, "skip_code": code}
        mark("pose")
        return new_state, accept, stats

    return step


MONO_SKIP_STRINGS = {0: "", 1: "keypoints", 2: "matches", 3: "inliers",
                     4: "support"}


class MonoOdometer:
    """Monocular frame-to-frame VO, with StereoOdometer's surface, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, K, nfeatures: int = 500, match_threshold: float = 0.8,
                 min_matches: int = 10, ransac_iters: int = 256,
                 inlier_px: float = 1.0, min_inliers: int = 15,
                 config: OdometerConfig | None = None, device="cuda"):
        if config is None:
            config = OdometerConfig(nfeatures=nfeatures,
                                    match_threshold=match_threshold,
                                    min_matches=min_matches)
        self.config = config
        self.device = target_device(device)
        self._state = init_state(config.orb.max_keypoints, self.device)
        self._step = make_step(K, config, ransac_iters, inlier_px,
                               min_inliers)
        self._graphs = {}       # input signature -> captured step (card)
        self.captured = None    # how the last update ran
        self.skipped_frames = 0
        self.skip_cause = ""
        self.last_stats = {}

    @property
    def state(self) -> MonoState:
        """The odometer's state. On a captured odometer it is the graph's
        static buffers (and its registered generator), which the next
        update overwrites, as JAX's donated state is invalid after the next
        step: copy what you keep."""
        return self._state

    @state.setter
    def state(self, state: MonoState) -> None:
        self._state = state
        self.skipped_frames = int(state.skipped)

    def update(self, img, trans_scale: float = 1.0, u=None) -> bool:
        """Process one (H, W) grayscale frame; True iff it was accepted
        (the first frame, or tracked). ``u``: the frame's (iters, 5)
        uniforms in place of the generator's draw. On the card (unless
        ``_graph.disable_capture()``) one replayed CUDA graph; its one host
        sync is the copy of the results, after which the replay's stage
        marks are read. Traced as ``ovo.update``
        (``openvo_tpu_torch/trace.py``)."""
        with trace.span("ovo.update"):
            with trace.span("ovo.prepare"):
                scale = torch.as_tensor(trans_scale, dtype=torch.float32)
                inputs = (img, scale) if u is None else (img, scale, u)
                self.captured = (self.device.type == "cuda"
                                 and capture_enabled())
                if self.captured:
                    inputs = tuple(torch.as_tensor(x) for x in inputs)
                    key = tuple((tuple(x.shape), x.dtype) for x in inputs)
                    if key not in self._graphs:
                        self._graphs[key] = capture(self._step)
                    step = self._graphs[key]
                else:
                    step = self._step
            if self.captured:
                self._state, accept, stats = step(self._state, *inputs)
            else:
                with trace.span("ovo.upload"):
                    # a CPU 0-d trans_scale multiplies as a scalar on the
                    # card too
                    inputs = ((torch.as_tensor(img, device=self.device),)
                              + inputs[1:])
                with trace.span("ovo.launch"):
                    self._state, accept, stats = step(self._state, *inputs)
            names = list(stats)
            with trace.span("ovo.wait"):
                vals = torch.stack(
                    [accept.to(torch.int32), self._state.skipped]
                    + [stats[k].to(torch.int32) for k in names]).cpu()
            trace.settle(self.device)
            with trace.span("ovo.unpack"):
                self.skipped_frames = int(vals[1])
                self.last_stats = {k: vals[2 + i].numpy() for i, k in
                                   enumerate(names)}
                self.skip_cause = MONO_SKIP_STRINGS[
                    int(self.last_stats["skip_code"])]
                return bool(vals[0])

    def current_pose(self):
        """camera-in-world pose = inv(c_T_w), float64 numpy."""
        return np.linalg.inv(self._state.c_T_w.cpu().numpy().astype(
            np.float64))
