"""The plain reference of one monocular odometer: its settings, the stream
of uniforms its samples come from, and its state machine, one frame and
one branch at a time.

Per frame: ORB on the whole image (``orb.py``, no mask), Lowe's ratio
test against the last accepted frame (``match.py``), the keypoints
normalized by the intrinsics, the essential matrix by five-point RANSAC
and recoverPose (``ransac.py``), the translation of unit norm scaled by
the caller's ``trans_scale``. The first frame is accepted as it is; a
later one is accepted where it has at least ``min_matches`` matches,
``min_inliers`` inliers and ``min_inliers // 2`` points of cheirality
support; a rejected frame leaves the state as it was and counts as
skipped. Its skip code is the first of keypoints (1), matches (2),
inliers (3) and support (4) that is short, the count of keypoints read
only where the frame is rejected.

The uniforms: the program's documented stream, a ``torch.Generator``
seeded 0 on the program's device, one (iters, 5) draw an update from the
first one on; update ``i`` takes draw ``i``.

``low=True`` is the control (``ransac.py``, ``fivepoint.py``, ``svd.py``),
with ORB's Harris response in bfloat16 (``orb.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from vobench.reference.geometry import rt_to_T
from vobench.reference.match import ratio_test_match
from vobench.reference.ransac import essential, recover_pose

SKIP_NONE, SKIP_KEYPOINTS, SKIP_MATCHES, SKIP_INLIERS, SKIP_SUPPORT = range(5)


@dataclasses.dataclass(frozen=True)
class Mono:
    """The odometer's settings: the intrinsics, the matcher's and the
    RANSAC's."""

    fx: float
    fy: float
    cx: float
    cy: float
    match_threshold: float
    min_matches: int
    ransac_iters: int
    inlier_px: float
    min_inliers: int

    @property
    def samples(self) -> int:
        """Five-point samples a frame: a quarter of the eight-point count
        (each gives up to 10 candidates), at least 16."""
        return max(self.ransac_iters // 4, 16)

    @property
    def threshold(self) -> float:
        """The Sampson threshold in normalized coordinates: (px over the
        mean focal length)^2."""
        return float((self.inlier_px / ((self.fx + self.fy) * 0.5)) ** 2)


def params(config: dict) -> Mono:
    """The settings of a configuration file's ``camera``, ``odometer`` and
    ``mono`` groups."""
    c = config["camera"]
    return Mono(fx=float(c["fx"]), fy=float(c["fy"]), cx=float(c["cx"]),
                cy=float(c["cy"]), **config["odometer"], **config["mono"])


class Draws:
    """The uniforms of update ``i``: the ``i``-th (samples, 5) draw of a
    generator seeded 0 on ``device``."""

    def __init__(self, samples: int, device):
        self.shape = (samples, 5)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(0)
        self.drawn = []

    def get(self, i: int):
        while len(self.drawn) <= i:
            self.drawn.append(torch.rand(self.shape, generator=self.gen,
                                         device=self.device))
        return self.drawn[i]


@dataclasses.dataclass
class Frame:
    """One frame's features on the device."""

    kp_xy: torch.Tensor     # (K, 2) float32
    desc: torch.Tensor      # (K, 32) uint8
    kp_valid: torch.Tensor  # (K,) bool


@dataclasses.dataclass
class State:
    """The odometer's state between two frames."""

    cur: Frame | None       # the last accepted frame
    c_T_w: torch.Tensor     # (4, 4) float32 world-in-camera, on the device
    skipped: int


@dataclasses.dataclass
class Step:
    """What one frame gave: accepted, its skip code, its matches and (where
    the frame reached the inlier test, else None) its inliers."""

    accept: bool
    code: int
    matches: int
    inliers: int | None


def initial_state(device) -> State:
    return State(None, torch.eye(4, dtype=torch.float32, device=device), 0)


def normalize(xy, p: Mono):
    return torch.stack([(xy[:, 0] - p.cx) / p.fx, (xy[:, 1] - p.cy) / p.fy],
                       dim=1)


def step(state: State, frame: Frame, u, trans_scale: float, p: Mono,
         low: bool = False) -> tuple[State, Step]:
    """One frame with the update's uniforms ``u``: (state', what it
    gave)."""
    if state.cur is None:
        return State(frame, state.c_T_w, 0), Step(True, SKIP_NONE, 0, 0)
    cur = state.cur
    few_kps = int(frame.kp_valid.sum()) < p.min_matches
    idx, mok = ratio_test_match(cur.desc, frame.desc, p.match_threshold,
                                cur.kp_valid, frame.kp_valid)
    matches = int(mok.sum())
    rejected = dataclasses.replace(state, skipped=state.skipped + 1)
    if matches < p.min_matches:
        code = SKIP_KEYPOINTS if few_kps else SKIP_MATCHES
        return rejected, Step(False, code, matches, None)
    x1 = normalize(cur.kp_xy, p)
    x2 = normalize(frame.kp_xy[idx.to(torch.int64)], p)
    E, inl, inliers = essential(x1, x2, mok, u, p.threshold, low)
    if inliers < p.min_inliers:
        code = SKIP_KEYPOINTS if few_kps else SKIP_INLIERS
        return rejected, Step(False, code, matches, inliers)
    R, t, support = recover_pose(E, x1, x2, inl, low)
    if int(support.sum()) < p.min_inliers // 2:
        code = SKIP_KEYPOINTS if few_kps else SKIP_SUPPORT
        return rejected, Step(False, code, matches, inliers)
    scale = torch.tensor(trans_scale, dtype=torch.float32, device=t.device)
    T = rt_to_T(R.to(torch.float32), (t * scale).to(torch.float32))
    return (State(frame, T @ state.c_T_w, 0),
            Step(True, SKIP_NONE, matches, inliers))
