"""StereoOdometer: the frame-to-frame tracking loop, PyTorch port of
``openvo_tpu/models/stereo_odometer.py``.

The per-frame update (rectify, SGBM, reproject, ORB, match, Kabsch, motion
gates, pose chain, skip/fallback state machine) runs on the camera's device
with the JAX package's observable semantics:

- skip causes {keypoints, matches, rigidity, outlier, nan, bigdist, bigrot}
  in the reference's assignment order (bigrot overwrites bigdist); the
  cause is sticky across successful frames;
- the motion gates scale with (skipped_frames + 1);
- on failure the frame state does not roll;
- the fallback matches against the prev-prev frame and composes onto the
  old c_T_w_prev;
- update() returns True for the first frame without computing a pose.

JAX runs the fallback attempt under ``lax.cond`` inside one jitted
program. Here the step computes it every frame and selects with
``torch.where`` (what ``lax.cond`` does under ``vmap``): the step reads
nothing on the host, so on the card ``update`` replays it as one CUDA
graph (``openvo_tpu_torch/_graph.py``, JAX's ``jit`` with donated state),
and its one sync is the copy of its results. That holds at every SGBM and
filter configuration: the two loops JAX runs as ``lax.while_loop``s on the
device, the speckle filter's labelling and the rigid clique's greedy
growth, are the kernels H7 and H8 there (``ops/speckle_cuda.py``,
``ops/clique_cuda.py``), which read nothing on the host.

Every stage takes a batch as well, a leading axis on each tensor, where
JAX maps the stage with ``jax.vmap``: ``extract`` over (B, H, W) frames
(``parallel/stream.py``, ``parallel/sharding.py``), ``attempt`` over B
pairs of features, and ``step_feats`` over a batch of states (the cameras
of ``parallel/rig.py``), each member selecting its own branch. The state is a
``NamedTuple`` of tensors with the JAX package's leaf order, so
:func:`state_from_jax_leaves` continues a sequence started in JAX, and
save_state/load_state read and write the same npz layout.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from openvo_tpu_torch.config import (
    SKIP_BIGDIST,
    SKIP_BIGROT,
    SKIP_CAUSE_STRINGS,
    SKIP_KEYPOINTS,
    SKIP_MATCHES,
    SKIP_NAN,
    SKIP_OUTLIER,
    SKIP_RIGIDITY,
    OdometerConfig,
)
from openvo_tpu_torch import trace
from openvo_tpu_torch._graph import (CapturedStep, capture, capture_enabled,
                                     mark)
from openvo_tpu_torch.geometry.se3 import rotation_magnitude
from openvo_tpu_torch.ops._dispatch import target_device
from openvo_tpu_torch.ops.hamming import ratio_test_match
from openvo_tpu_torch.ops.interpolate import bilinear_sample_3d
from openvo_tpu_torch.ops.orb import detect_and_compute
from openvo_tpu_torch.pose.kabsch import kabsch
from openvo_tpu_torch.pose.outlier import outlier_filter
from openvo_tpu_torch.pose.rigid_clique import rigid_body_filter


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame data."""

    img: torch.Tensor       # (Hc, Wc) cropped rectified gray frame
    xyz: torch.Tensor       # (Hc, Wc, 3) reprojected 3D image
    disp: torch.Tensor      # (Hc, Wc) disparity (float px)
    kp_xy: torch.Tensor     # (K, 2) keypoint coords (x, y), level-0 frame
    desc: torch.Tensor      # (K, 32) packed 256-bit descriptors
    kp_valid: torch.Tensor  # (K,) bool


class OdomState(NamedTuple):
    cur: FrameFeatures
    prev: FrameFeatures
    has_cur: torch.Tensor     # () bool
    has_prev: torch.Tensor    # () bool
    c_T_w: torch.Tensor       # (4, 4) world-in-camera
    c_T_w_prev: torch.Tensor  # (4, 4)
    skipped: torch.Tensor     # () int32
    skip_code: torch.Tensor   # () int32


def _empty_features(shape, K, device):
    Hc, Wc = shape
    return FrameFeatures(
        img=torch.zeros((Hc, Wc), dtype=torch.float32, device=device),
        xyz=torch.zeros((Hc, Wc, 3), dtype=torch.float32, device=device),
        disp=torch.zeros((Hc, Wc), dtype=torch.float32, device=device),
        kp_xy=torch.zeros((K, 2), dtype=torch.float32, device=device),
        desc=torch.zeros((K, 32), dtype=torch.uint8, device=device),
        kp_valid=torch.zeros((K,), dtype=torch.bool, device=device),
    )


def init_state(cropped_shape, max_keypoints: int,
               device="cuda") -> OdomState:
    device = target_device(device)
    return OdomState(
        cur=_empty_features(cropped_shape, max_keypoints, device),
        prev=_empty_features(cropped_shape, max_keypoints, device),
        has_cur=torch.tensor(False, device=device),
        has_prev=torch.tensor(False, device=device),
        c_T_w=torch.eye(4, dtype=torch.float32, device=device),
        c_T_w_prev=torch.eye(4, dtype=torch.float32, device=device),
        skipped=torch.tensor(0, dtype=torch.int32, device=device),
        skip_code=torch.tensor(0, dtype=torch.int32, device=device),
    )


def state_leaves(state: OdomState):
    """The state's tensors in JAX ``tree_flatten`` order (18 leaves)."""
    return [*state.cur, *state.prev, *state[2:]]


def state_from_jax_leaves(leaves, device="cuda") -> OdomState:
    """Build the port's state from the numpy leaves of a JAX ``OdomState``
    (``jax.tree_util.tree_flatten`` order, as the JAX save_state writes
    them), so a sequence started in JAX continues here."""
    device = target_device(device)
    n = len(FrameFeatures._fields)
    if len(leaves) != 2 * n + 6:
        raise ValueError(f"expected {2 * n + 6} leaves, got {len(leaves)}")
    t = [torch.as_tensor(np.array(x), device=device) for x in leaves]
    return OdomState(FrameFeatures(*t[:n]), FrameFeatures(*t[n:2 * n]),
                     *t[2 * n:])


def _compose(a, b):
    """``a @ b`` of float32 4x4 transforms, in float64 and rounded once: a
    batch gives each member the bits of its own product."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.float32)


def _bcast(m, x):
    """Per-item mask ``m`` (B,) or () broadcast against ``x`` (B, ...)."""
    return m.reshape(m.shape + (1,) * (x.ndim - m.ndim))


def make_point_cloud_transform(cfg: OdometerConfig):
    """Filters, transform fit and motion gates with the reference's gating
    order: the rigid clique (if on), the rigidity cause below 10 points,
    the outlier pass (if on, only with >= 10 points), too few points
    counted after it, then the NaN, bigdist and bigrot gates.
    Returns fn(pts_a, pts_b, mask, skipped, skip_code) -> (T, ok, code);
    (B, N, 3) clouds with (B,) counters give (B, 4, 4), (B,), (B,)."""

    def point_cloud_transform(pts_a, pts_b, mask, skipped, skip_code):
        if cfg.rigidity_threshold > 0:
            clique = rigid_body_filter(pts_a, pts_b, mask,
                                       cfg.rigidity_threshold)
            mask = mask & (clique > 0)
        n1 = mask.to(torch.int32).sum(-1)
        rigidity_cause = n1 < 10
        skip_code = torch.where(rigidity_cause, SKIP_RIGIDITY, skip_code)
        if cfg.outlier_threshold > 0:
            refined = outlier_filter(pts_a, pts_b, mask,
                                     cfg.outlier_threshold)
            mask = torch.where((n1 >= 10)[..., None], refined, mask)
        too_few = mask.to(torch.int32).sum(-1) < cfg.min_matches
        skip_code = torch.where(too_few & ~rigidity_cause, SKIP_OUTLIER,
                                skip_code)
        T = kabsch(pts_a, pts_b, mask)
        is_nan = torch.isnan(T).flatten(-2).any(-1)
        skip_code = torch.where(~too_few & is_nan, SKIP_NAN, skip_code)
        lim = (skipped + 1).to(torch.float32)
        big_dist = (torch.linalg.norm(T[..., :3, 3], dim=-1)
                    > cfg.max_distance_change * lim)
        big_rot = (rotation_magnitude(T[..., :3, :3])
                   > cfg.max_rotation_change * lim)
        gates_on = ~too_few & ~is_nan
        # bigdist then bigrot: bigrot wins if both fire
        skip_code = torch.where(gates_on & big_dist, SKIP_BIGDIST, skip_code)
        skip_code = torch.where(gates_on & big_rot, SKIP_BIGROT, skip_code)
        ok = gates_on & ~big_dist & ~big_rot
        return T, ok, skip_code.to(torch.int32)

    return point_cloud_transform


def make_pipeline_fns(camera, cfg: OdometerConfig, color: bool):
    """The odometer's stages as functions: extract, point_clouds,
    point_cloud_transform, attempt and step_feats."""
    compute3d = camera.compute_3d_fn(color, cfg.preprocessed_frames)

    def extract(img_left, img_right) -> FrameFeatures:
        xyz, disp, img = compute3d(img_left, img_right)
        mark("depth")
        fmask = ((disp >= cfg.min_valid_disparity)
                 & (disp <= cfg.max_valid_disparity)).to(torch.uint8)
        feats = detect_and_compute(img, fmask, cfg.orb)
        mark("orb")
        return FrameFeatures(img=img, xyz=xyz, disp=disp, kp_xy=feats["xy"],
                             desc=feats["desc"], kp_valid=feats["valid"])

    def point_clouds(fa: FrameFeatures, fb: FrameFeatures):
        """Match fa -> fb and sample both 3D images at the matched
        keypoints."""
        train_idx, mok = ratio_test_match(fa.desc, fb.desc,
                                          cfg.match_threshold, fa.kp_valid,
                                          fb.kp_valid)
        n = mok.to(torch.int32).sum(-1)
        pts_a = bilinear_sample_3d(fa.xyz, fa.kp_xy[..., 0], fa.kp_xy[..., 1])
        idx = train_idx.to(torch.int64)[..., None].expand(fb.kp_xy.shape)
        xy_b = torch.gather(fb.kp_xy, -2, idx)
        pts_b = bilinear_sample_3d(fb.xyz, xy_b[..., 0], xy_b[..., 1])
        return pts_a, pts_b, mok, n >= cfg.min_matches, n

    point_cloud_transform = make_point_cloud_transform(cfg)

    def attempt(fa, fb, skipped, skip_code_in):
        """One matching + fit attempt with the 'matches' gate."""
        pts_a, pts_b, mok, enough, n = point_clouds(fa, fb)
        mark("match")
        T, ok, code_t = point_cloud_transform(pts_a, pts_b, mok, skipped,
                                              skip_code_in)
        code_out = torch.where(enough, code_t, SKIP_MATCHES).to(torch.int32)
        mark("pose")
        return T, ok & enough, code_out, n

    return {
        "extract": extract,
        "point_clouds": point_clouds,
        "point_cloud_transform": point_cloud_transform,
        "attempt": attempt,
        "step_feats": make_feats_step(cfg, attempt),
    }


KEEP = -1   # a skip code no gate sets: "the code attempt 1 left"


def make_feats_step(cfg: OdometerConfig, attempt):
    """The state-machine half of the step, on precomputed FrameFeatures:
    (state, feats) -> (state', success, stats). A batch of states and
    features (the cameras of a rig) steps each member on its own, each
    taking its own branch's result. No value is read on the host."""

    def step_feats(state: OdomState, feats: FrameFeatures):
        n_kps = feats.kp_valid.to(torch.int32).sum(-1)
        few_kps = n_kps < cfg.min_matches
        first = ~state.has_cur

        # Attempt 1 against the last accepted frame and the fallback,
        # attempt 2, against the frame before it (reference :139-150): JAX's
        # lax.cond on the device. Both run as one batch of twice the size;
        # attempt 2 starts from attempt 1's skip code, which it keeps where
        # none of its gates fires (KEEP marks that), and it is taken where
        # use2 holds. Elsewhere every output is attempt 1's (ok2 false, the
        # code and n_matches attempt 1's), and a NaN of an attempt on the
        # empty state stays in the branch torch.where does not take.
        single = state.has_cur.ndim == 0

        def pair(a, b):
            return torch.stack([a, b]) if single else torch.cat([a, b])

        def halves(x):
            return (x[0], x[1]) if single else x.chunk(2)

        def fits(f):   # the fields attempt reads
            return f._replace(img=None, disp=None)

        fa = FrameFeatures(*(None if a is None else pair(a, b) for a, b in
                             zip(fits(state.cur), fits(state.prev))))
        fb = FrameFeatures(*(None if a is None else pair(a, a)
                             for a in fits(feats)))
        T, okb, code, nm = attempt(
            fa, fb, pair(state.skipped, state.skipped),
            pair(state.skip_code, torch.full_like(state.skip_code, KEEP)))
        (T1, T2), (ok1, ok2), (code1, code2), (nm1, nm2) = map(
            halves, (T, okb, code, nm))
        code2 = torch.where(code2 == KEEP, code1, code2)
        use2 = ~ok1 & state.has_prev
        ok = ok1 | (use2 & ok2)
        code_final = torch.where(use2, code2, code1)

        def where(m, a, b):
            return torch.where(_bcast(m, a), a, b)

        # Attempt 1 composes onto c_T_w, the fallback onto the old
        # c_T_w_prev (skipping the failed frame's motion).
        c_T_w_new = where(ok1, _compose(T1, state.c_T_w),
                          where(use2 & ok2, _compose(T2, state.c_T_w_prev),
                                state.c_T_w))
        c_T_w_prev_new = where(ok, state.c_T_w, state.c_T_w_prev)

        success = ~few_kps & (first | ok)
        tracked = ~few_kps & ~first & ok

        def sel(a, b):
            return type(a)(*(where(success, x, y) for x, y in zip(a, b)))

        zero = torch.zeros_like(state.skipped)
        new_state = OdomState(
            cur=sel(feats, state.cur),
            prev=sel(state.cur, state.prev),
            has_cur=state.has_cur | success,
            has_prev=torch.where(success, state.has_cur, state.has_prev),
            c_T_w=where(tracked, c_T_w_new, state.c_T_w),
            c_T_w_prev=where(tracked, c_T_w_prev_new, state.c_T_w_prev),
            skipped=torch.where(success, torch.where(first, state.skipped,
                                                     zero),
                                state.skipped + 1).to(torch.int32),
            skip_code=torch.where(
                few_kps, SKIP_KEYPOINTS,
                torch.where(first, state.skip_code, code_final)
            ).to(torch.int32),
        )
        stats = {
            "n_kps": n_kps,
            "n_matches": torch.where(use2, nm2, nm1),
            "ok1": ok1,
            "ok2": use2 & ok2,
            "skip_code": new_state.skip_code,
            "use2": use2,
        }
        mark("state")
        return new_state, success, stats

    return step_feats


def make_step(camera, cfg: OdometerConfig, color: bool):
    """The step function (state, imgL, imgR) -> (state', ok, stats)."""
    fns = make_pipeline_fns(camera, cfg, color)
    extract, step_feats = fns["extract"], fns["step_feats"]

    def step(state: OdomState, img_left, img_right):
        return step_feats(state, extract(img_left, img_right))

    return step


# use2: the fallback's result was taken (trace counter ``ovo.fallback``)
STAT_NAMES = ("n_kps", "n_matches", "ok1", "ok2", "skip_code", "use2")


def make_update_fn(camera, cfg: OdometerConfig, color: bool):
    """The step with its results packed for the host: (state, imgL, imgR)
    -> (state', vals), vals int32 (3 + len(STAT_NAMES)[, B]) of ok, skipped,
    skip_code and STAT_NAMES' stats, which an update copies to the host in
    its one sync. Captured, its graph begins with the ``start`` mark."""
    step = make_step(camera, cfg, color)

    def update(state: OdomState, img_left, img_right):
        mark("start")
        state, ok, stats = step(state, img_left, img_right)
        return state, torch.stack(
            [ok.to(torch.int32), state.skipped, state.skip_code]
            + [stats[k].to(torch.int32) for k in STAT_NAMES])

    return update


def run_update(step, state, inputs, device):
    """One call of an update function, the captured one (a
    :class:`CapturedStep`, which records its own upload and launch spans)
    or the eager one: (state', vals on the host). The copy of vals is the
    call's one sync; the trace's marks are read after it."""
    if not isinstance(step, CapturedStep):
        with trace.span("ovo.upload"):
            inputs = [torch.as_tensor(x, device=device) for x in inputs]
        with trace.span("ovo.launch"):
            state, vals = step(state, *inputs)
    else:
        state, vals = step(state, *inputs)
    with trace.span("ovo.wait"):
        vals = vals.cpu()
    trace.settle(device)
    return state, vals


def unpack_stats(vals) -> dict:
    """STAT_NAMES' rows of an update's vals (numpy, on the host); counts
    the camera-steps that took the fallback's result
    (``ovo.fallback``)."""
    stats = {k: vals[3 + i, ...] for i, k in enumerate(STAT_NAMES)}
    if trace.recording():
        trace.count("ovo.fallback", int(stats["use2"].sum()))
    return stats


class StereoOdometer:
    """The reference StereoOdometer's surface (same defaults), running on
    the camera's device.

    On the card each ``update`` replays the step as one CUDA graph
    (``openvo_tpu_torch/_graph.py``), captured on the first update and
    cached on the camera per (config, color), as JAX caches its jitted
    step; ``captured`` says whether the last update did. It runs eagerly
    on the CPU and under ``_graph.disable_capture()``."""

    MIN_VALID_DISPARITY = 4
    MAX_VALID_DISPARITY = 100
    MAX_DISTANCE_CHANGE = 1.0
    MAX_ROTATION_CHANGE = float(np.pi / 3)

    def __init__(self, stereo_camera, nfeatures: int = 500,
                 match_threshold: float = 0.8,
                 rigidity_threshold: float = 0.0,
                 outlier_threshold: float = 0.0,
                 preprocessed_frames: bool = False,
                 min_matches: int = 10,
                 config: OdometerConfig | None = None):
        self.stereo = stereo_camera
        if config is None:
            config = OdometerConfig(
                nfeatures=nfeatures,
                match_threshold=match_threshold,
                rigidity_threshold=rigidity_threshold,
                outlier_threshold=outlier_threshold,
                preprocessed_frames=preprocessed_frames,
                min_matches=min_matches,
            )
        self.config = config
        self.device = stereo_camera.device
        self._pct = make_point_cloud_transform(config)
        self._state = init_state(stereo_camera.cropped_shape,
                                 config.orb.max_keypoints, self.device)
        self._steps = {}
        self.captured = None
        self.skipped_frames = 0
        self.skip_cause = ""
        self.last_stats = {}

    @property
    def state(self) -> OdomState:
        """The odometer's state. On a captured odometer it is the graph's
        static buffers, which the next update overwrites, as JAX's donated
        state is invalid after the next step: copy what you keep."""
        return self._state

    @state.setter
    def state(self, state: OdomState) -> None:
        self._state = state
        self._sync_counters()

    def _sync_counters(self):
        vals = torch.stack([self._state.skipped,
                            self._state.skip_code]).cpu()
        self.skipped_frames = int(vals[0])
        self.skip_cause = SKIP_CAUSE_STRINGS[int(vals[1])]

    def _update_fn(self, color: bool):
        """The update function for ``color`` images: on the card (unless
        capture is disabled) the captured step the camera caches per
        (config, color), else the eager one."""
        key = (self.config, color)
        if self.device.type == "cuda" and capture_enabled():
            cache = self.stereo.__dict__.setdefault("_step_cache", {})
            if key not in cache:
                cache[key] = capture(make_update_fn(self.stereo, self.config,
                                                    color))
            return cache[key]
        if key not in self._steps:
            self._steps[key] = make_update_fn(self.stereo, self.config, color)
        return self._steps[key]

    def _claim(self, step: CapturedStep) -> None:
        """Make ``step``'s static buffers this odometer's: another odometer
        of the same camera and config whose state they hold keeps a copy."""
        other = step.holder() if step.holder is not None else None
        if other is not None and other is not self and \
                other._state is step.state:
            other._state = tree_map(torch.clone, step.state)
        step.holder = weakref.ref(self)

    def update(self, img_left, img_right) -> bool:
        """Process one stereo pair; True iff tracking succeeded. Its one
        host sync is the copy of the results. Traced as ``ovo.update``
        (``openvo_tpu_torch/trace.py``)."""
        with trace.span("ovo.update"):
            with trace.span("ovo.prepare"):
                ndim = (img_left.ndim if torch.is_tensor(img_left)
                        else np.ndim(img_left))
                step = self._update_fn(ndim == 3)
                self.captured = isinstance(step, CapturedStep)
                if self.captured:
                    self._claim(step)
            self._state, vals = run_update(step, self._state,
                                           (img_left, img_right), self.device)
            with trace.span("ovo.unpack"):
                vals = vals.numpy()
                self.skipped_frames = int(vals[1])
                self.skip_cause = SKIP_CAUSE_STRINGS[int(vals[2])]
                self.last_stats = unpack_stats(vals)
                return bool(vals[0])

    def current_pose(self):
        """camera-in-world pose = inv(c_T_w), float64 numpy."""
        return np.linalg.inv(self.c_T_w.astype(np.float64))

    # -- reference helper methods ------------------------------------------

    def feature_mask(self, disparity):
        """uint8 0/255 mask of pixels with reliable depth."""
        d = np.asarray(disparity)
        mask = (d >= self.MIN_VALID_DISPARITY) & (d <= self.MAX_VALID_DISPARITY)
        return mask.astype(np.uint8) * 255

    def bilinear_interpolate_pixels(self, img, x, y):
        """Inf-aware renormalizing bilinear sample of an (H, W, 3) 3D image
        at one subpixel position."""
        out = bilinear_sample_3d(
            torch.as_tensor(np.asarray(img, np.float32)),
            torch.tensor([float(x)], dtype=torch.float32),
            torch.tensor([float(y)], dtype=torch.float32))
        return out.numpy()[0]

    def valid_distance_change(self, prev_kp_idx, current_kp_idx):
        """Distance-change plausibility test between a previous and a
        current keypoint (rows of prev_kps / current_kps): the drop in the
        3D points' distance from the camera is at most MAX_DISTANCE_CHANGE
        x (skipped_frames + 1)."""
        p_x, p_y = self.prev_kps[prev_kp_idx]
        c_x, c_y = self.current_kps[current_kp_idx]
        d_prev = np.linalg.norm(self.prev_3d[int(p_y)][int(p_x)])
        d_cur = np.linalg.norm(self.current_3d[int(c_y)][int(c_x)])
        limit = self.MAX_DISTANCE_CHANGE * (self.skipped_frames + 1)
        return bool(d_prev - d_cur <= limit)

    def rigid_body_filter(self, prev_pts, pts):
        """Greedy max-clique rigidity filter of (N, 3) point arrays at the
        config's rigidity_threshold; 0/1 int32 numpy array."""
        prev_pts = torch.as_tensor(np.asarray(prev_pts, np.float32),
                                   device=self.device)
        pts = torch.as_tensor(np.asarray(pts, np.float32), device=self.device)
        mask = torch.ones(len(pts), dtype=torch.bool, device=self.device)
        return rigid_body_filter(prev_pts, pts, mask,
                                 self.config.rigidity_threshold).cpu().numpy()

    def point_cloud_transform(self, current_pts, next_pts):
        """Filters, rigid fit and motion gates; the 4x4 transform, or None
        (setting skip_cause) when a gate fails."""
        cur = torch.as_tensor(np.asarray(current_pts, np.float32),
                              device=self.device)
        nxt = torch.as_tensor(np.asarray(next_pts, np.float32),
                              device=self.device)
        T, ok, code = self._pct(
            cur, nxt, torch.ones(len(cur), dtype=torch.bool,
                                 device=self.device),
            torch.tensor(self.skipped_frames, dtype=torch.int32,
                         device=self.device),
            torch.tensor(0, dtype=torch.int32, device=self.device))
        code = int(code)
        if code:
            self.skip_cause = SKIP_CAUSE_STRINGS[code]
        return T.cpu().numpy() if bool(ok) else None

    # -- reference attribute surface ---------------------------------------

    @property
    def c_T_w(self):
        return self._state.c_T_w.cpu().numpy()

    @property
    def current_img(self):
        return self._state.cur.img.cpu().numpy()

    @property
    def current_3d(self):
        return self._state.cur.xyz.cpu().numpy()

    @property
    def current_disparity(self):
        return self._state.cur.disp.cpu().numpy()

    @property
    def prev_img(self):
        return self._state.prev.img.cpu().numpy()

    @property
    def prev_disparity(self):
        return self._state.prev.disp.cpu().numpy()

    @property
    def prev_3d(self):
        return self._state.prev.xyz.cpu().numpy()

    @property
    def current_kps(self):
        f = self._state.cur
        return f.kp_xy[f.kp_valid].cpu().numpy()

    @property
    def current_desc(self):
        f = self._state.cur
        return f.desc[f.kp_valid].cpu().numpy()

    @property
    def prev_kps(self):
        f = self._state.prev
        return f.kp_xy[f.kp_valid].cpu().numpy()

    @property
    def prev_desc(self):
        f = self._state.prev
        return f.desc[f.kp_valid].cpu().numpy()

    # -- checkpoint / resume: the JAX package's npz layout -----------------

    def save_state(self, path):
        leaves = state_leaves(self._state)
        np.savez(path, n_leaves=len(leaves),
                 **{f"leaf_{i}": x.cpu().numpy() for i, x in
                    enumerate(leaves)})
        return path

    def load_state(self, path):
        with np.load(path) as z:
            leaves = [z[f"leaf_{i}"] for i in range(int(z["n_leaves"]))]
        self.state = state_from_jax_leaves(leaves, self.device)
