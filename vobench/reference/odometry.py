"""The plain reference of one stereo odometer: the camera (rectification,
SGBM, reprojection, crop), the per-frame extraction (depth, ORB) and the
odometer's state machine, written as the openVO reference writes it, one
frame and one branch at a time.

The semantics are the openVO ``StereoOdometer``'s: skip causes in the
reference's assignment order (bigrot overwrites bigdist), the cause sticky
across successful frames, the motion gates scaled by (skipped + 1), no
state roll on failure, and the fallback attempt against the frame before
the last accepted one, composed onto the old ``c_T_w_prev``. The filters
(rigid clique, outlier pass; ``filters.py``) run where the configuration's
thresholds are set.

``low=True`` is the control: the same computation with the box-summed cost
held in 8 bits, the Harris response in bfloat16 and the 3D points in
bfloat16, each the next precision below the configuration's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from vobench.reference.filters import outlier_pass, rigid_clique
from vobench.reference.geometry import (kabsch_fit_plain,
                                        reproject_image_to_3d,
                                        rotation_magnitude)
from vobench.reference.match import bilinear_sample_3d, ratio_test_match
from vobench.reference.orb import detect_and_compute
from vobench.reference.rectify import (init_undistort_rectify_map,
                                       stereo_rectify)
from vobench.reference.remap import make_remap
from vobench.reference.sgbm import disparity16

SKIP_NONE, SKIP_KEYPOINTS, SKIP_MATCHES, SKIP_RIGIDITY, SKIP_OUTLIER = range(5)
SKIP_NAN, SKIP_BIGDIST, SKIP_BIGROT = 5, 6, 7


@dataclasses.dataclass(frozen=True)
class SGBM:
    min_disparity: int
    num_disparities: int
    block_size: int
    p1: int
    p2: int
    disp12_max_diff: int
    pre_filter_cap: int
    uniqueness_ratio: int
    speckle_window_size: int
    speckle_range: int
    num_paths: int = 5

    @property
    def effective_p1(self) -> int:
        return self.p1 if self.p1 > 0 else 8 * self.block_size ** 2

    @property
    def effective_p2(self) -> int:
        p2 = self.p2 if self.p2 > 0 else 32 * self.block_size ** 2
        return max(p2, self.effective_p1 + 1)


@dataclasses.dataclass(frozen=True)
class ORB:
    nfeatures: int
    scale_factor: float
    nlevels: int
    edge_threshold: int
    fast_threshold: int
    patch_size: int
    harris_k: float
    cv2_ranking: bool
    max_keypoints: int
    low: bool = False


@dataclasses.dataclass(frozen=True)
class Odometer:
    match_threshold: float
    min_matches: int
    min_valid_disparity: float
    max_valid_disparity: float
    max_distance_change: float
    max_rotation_change: float
    rigidity_threshold: float = 0.0
    outlier_threshold: float = 0.0


def params(config: dict, low: bool = False):
    """(SGBM, ORB, Odometer) of a configuration file's ``sgbm``, ``orb`` and
    ``odometer`` groups; the rotation gate is given as pi over a number."""
    odo = dict(config["odometer"])
    odo["max_rotation_change"] = math.pi / odo.pop(
        "max_rotation_change_pi_over")
    o = Odometer(**odo)
    return SGBM(**config["sgbm"]), ORB(**config["orb"], low=low), o


class Features(NamedTuple):
    """One frame's (or a batch's) extracted features."""

    xyz: torch.Tensor       # (Hc, Wc, 3) cropped 3D image, inf where invalid
    disp: torch.Tensor      # (Hc, Wc) disparity in px, -1 where invalid
    kp_xy: torch.Tensor     # (K, 2) level-0 keypoint coordinates
    desc: torch.Tensor      # (K, 32) packed descriptors
    kp_valid: torch.Tensor  # (K,) bool


class Camera:
    """An ideal rectified stereo camera (both cameras the configuration's
    intrinsics, no distortion, the right camera ``baseline`` to the right): rectification
    by cv2.stereoRectify's rules, maps, Q and the valid-region crop."""

    def __init__(self, camera: dict, sgbm: SGBM, device):
        w, h = camera["width"], camera["height"]
        K = np.array([[camera["fx"], 0, camera["cx"]],
                      [0, camera["fy"], camera["cy"]], [0, 0, 1.0]])
        dist = np.zeros(5)
        R1, R2, P1, P2, Q, roi, _ = stereo_rectify(
            K, dist, K, dist, (w, h), np.eye(3),
            np.array([-camera["baseline_m"], 0.0, 0.0]))
        self.device = torch.device(device)

        def remap(R, P):
            mx, my = init_undistort_rectify_map(K, dist, R, P, (w, h))
            return make_remap(*(torch.as_tensor(np.asarray(m, np.float32),
                                                device=self.device)
                                for m in (mx, my)))

        self.remap_left, self.remap_right = remap(R1, P1), remap(R2, P2)
        self.Q = torch.as_tensor(np.asarray(Q, np.float32),
                                 device=self.device)
        x, y, rw, rh = roi
        self.crop = (slice(y, rh), slice(x, rw))
        self.sgbm = sgbm

    def extract(self, lefts, rights, orb: ORB, odo: Odometer) -> Features:
        """Features of (B, H, W) uint8 pairs: rectify, SGBM, reproject,
        crop, the reliable-depth mask, ORB."""
        left = self.remap_left(lefts.to(self.device, torch.float32))
        right = self.remap_right(rights.to(self.device, torch.float32))
        disp = disparity16(left, right, self.sgbm,
                           cost_bits=8 if orb.low else 16)
        disp = disp.to(torch.float32) / 16.0
        xyz = reproject_image_to_3d(disp, self.Q)
        if orb.low:
            xyz = xyz.to(torch.bfloat16).to(torch.float32)
        valid = disp >= (self.sgbm.min_disparity - 0.75)
        xyz = torch.where(valid[..., None], xyz, float("inf"))
        ys, xs = self.crop
        xyz, disp, img = xyz[:, ys, xs], disp[:, ys, xs], left[:, ys, xs]
        fmask = ((disp >= odo.min_valid_disparity)
                 & (disp <= odo.max_valid_disparity)).to(torch.uint8)
        f = detect_and_compute(img, fmask, orb)
        return Features(xyz, disp, f["xy"], f["desc"], f["valid"])


@dataclasses.dataclass
class State:
    """The odometer's state between two frames."""

    cur: Features | None        # the last accepted frame's features
    prev: object                # the accepted frame before it: Features,
                                # a function that returns them, or None
    c_T_w: torch.Tensor         # (4, 4) float32 world-in-camera, host
    c_T_w_prev: torch.Tensor    # (4, 4) float32, host
    skipped: int
    skip_code: int


def initial_state() -> State:
    eye = torch.eye(4, dtype=torch.float32)
    return State(None, None, eye, eye.clone(), 0, SKIP_NONE)


def compose(a, b):
    """``a @ b`` of float32 4x4 transforms, in float64, rounded once."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.float32)


class Fit(NamedTuple):
    """The match, filters and fit of one ordered pair of frames: what a
    step needs of it, on the host."""

    T: torch.Tensor | None   # (4, 4) float32 on the host; None: too few
    matches: int
    rigid_few: bool          # under 10 points after the rigid clique
    too_few: bool            # under min_matches after the filters
    distance: float          # |t| of T
    rotation: float          # rotation_magnitude of T's rotation
    nan: bool


def fit(fa: Features, fb: Features, odo: Odometer) -> Fit:
    """Match fa -> fb, filter (the rigid clique, then the outlier pass on
    10 points or more, each where its threshold is set) and fit the rigid
    transform. Depends on the two frames alone, so a caller may keep it
    for a pair seen again."""
    idx, mok = ratio_test_match(fa.desc, fb.desc, odo.match_threshold,
                                fa.kp_valid, fb.kp_valid)
    n = int(mok.sum())
    if n < odo.min_matches:
        return Fit(None, n, False, False, 0.0, 0.0, False)
    pts_a = bilinear_sample_3d(fa.xyz, fa.kp_xy[:, 0], fa.kp_xy[:, 1])
    xy_b = fb.kp_xy[idx.to(torch.int64)]
    pts_b = bilinear_sample_3d(fb.xyz, xy_b[:, 0], xy_b[:, 1])
    mask = mok
    if odo.rigidity_threshold > 0:
        mask = mask & rigid_clique(pts_a, pts_b, mask,
                                   odo.rigidity_threshold)
    n1 = int(mask.sum())
    if odo.outlier_threshold > 0 and n1 >= 10:
        mask = outlier_pass(pts_a, pts_b, mask, odo.outlier_threshold)
    too_few = int(mask.sum()) < odo.min_matches
    T = kabsch_fit_plain(pts_a[None], pts_b[None], mask[None])[0]
    return Fit(T.cpu(), n, n1 < 10, too_few,
               float(torch.linalg.norm(T[:3, 3])),
               float(rotation_magnitude(T[:3, :3])),
               bool(torch.isnan(T).any()))


def attempt(f: Fit, skipped: int, code: int, odo: Odometer):
    """Gate a fit: (T, ok, skip code, matches). ``code`` is the code a gate
    that does not fire leaves; the order is the reference's: matches,
    rigidity (sticky), too few after the filters (outlier), NaN, bigdist,
    bigrot (bigrot overwrites bigdist)."""
    if f.matches < odo.min_matches:
        return None, False, SKIP_MATCHES, f.matches
    if f.rigid_few:
        code = SKIP_RIGIDITY
    if f.too_few:
        return f.T, False, code if f.rigid_few else SKIP_OUTLIER, f.matches
    if f.nan:
        return f.T, False, SKIP_NAN, f.matches
    lim = float(skipped + 1)
    ok = True
    if f.distance > odo.max_distance_change * lim:
        code, ok = SKIP_BIGDIST, False
    if f.rotation > odo.max_rotation_change * lim:
        code, ok = SKIP_BIGROT, False
    return f.T, ok, code, f.matches


def step(state: State, feats: Features, odo: Odometer, fit_of=None,
         keypoints=None):
    """One frame: (state', success, matches of the attempt taken). The
    attempts run also for a frame with too few keypoints, whose matches
    are reported all the same. ``fit_of(fa, fb)`` may stand in for
    :func:`fit` (a cache of pairs seen before), ``keypoints`` for the
    frame's count of valid keypoints. Poses are composed on the host."""
    fit_of = fit_of or (lambda a, b: fit(a, b, odo))
    s = dataclasses.replace(state)
    if keypoints is None:
        keypoints = int(feats.kp_valid.sum())
    few = keypoints < odo.min_matches
    if s.cur is None:
        if few:
            s.skipped += 1
            s.skip_code = SKIP_KEYPOINTS
            return s, False, 0
        s.cur = feats
        return s, True, 0
    T, ok, code, n = attempt(fit_of(s.cur, feats), s.skipped, s.skip_code,
                             odo)
    base = s.c_T_w
    if not ok and s.prev is not None:
        prev = s.prev() if callable(s.prev) else s.prev
        T, ok, code, n = attempt(fit_of(prev, feats), s.skipped, code, odo)
        base = s.c_T_w_prev
    if few:
        s.skipped += 1
        s.skip_code = SKIP_KEYPOINTS
        return s, False, n
    s.skip_code = code
    if not ok:
        s.skipped += 1
        return s, False, n
    s.c_T_w, s.c_T_w_prev = compose(T, base), s.c_T_w
    s.prev, s.cur = s.cur, feats
    s.skipped = 0
    return s, True, n
