"""StereoCamera: calibration holder + per-frame depth pipeline, PyTorch port
of ``openvo_tpu/models/stereo_camera.py``.

Set-up (stereoRectify, undistort maps) runs once in NumPy
(``geometry/rectify.py``, shared with the JAX package); the maps, Q and the
per-frame path gray -> remap -> SGBM -> reproject -> crop live on the
camera's ``device``. The same K/dist/R/T give the same maps as the JAX
camera, so a camera needs no state carried across.

Quirk kept from the reference: the valid-region crop slices
``img[roi[1]:roi[3], roi[0]:roi[2]]``, treating the ROI's (w, h) as end
coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from openvo_tpu_torch._graph import capture, capture_enabled
from openvo_tpu_torch.config import SGBMParams
from openvo_tpu_torch.geometry.rectify import (init_undistort_rectify_map,
                                               stereo_rectify)
from openvo_tpu_torch.geometry.reproject import reproject_image_to_3d
from openvo_tpu_torch.io.calib import SGBM_KEYS, load_pfiles
from openvo_tpu_torch.ops._dispatch import target_device
# bgr_to_gray lives in ops/image.py, as in the JAX package; importing it
# from this module keeps working
from openvo_tpu_torch.ops.image import bgr_to_gray
from openvo_tpu_torch.ops.remap import make_remap, remap_bilinear, remap_u8
from openvo_tpu_torch.ops.sgbm import sgbm_disparity


def _sgbm_params_from_dict(d) -> SGBMParams:
    """Accept the reference's pickle dict keys."""
    return SGBMParams(
        min_disparity=int(d["minDisparity"]),
        num_disparities=int(d["numDisparities"]),
        block_size=int(d["blockSize"]),
        p1=int(d["P1"]),
        p2=int(d["P2"]),
        disp12_max_diff=int(d["disp12MaxDiff"]),
        pre_filter_cap=int(d["preFilterCap"]),
        uniqueness_ratio=int(d["uniquenessRatio"]),
        speckle_window_size=int(d["speckleWindowSize"]),
        speckle_range=int(d["speckleRange"]),
    )


class StereoCamera:
    """Holds calibration; builds rectify maps once; computes per-frame 3D."""

    @classmethod
    def from_pfiles(cls, left_cam_file, right_cam_file, rect_file, sgbm_file,
                    img_size, device="cuda"):
        """Calibration from the reference's four pickles: {'K', 'dist'}
        of each camera, {'R', 'T'}, and the SGBM parameter dict."""
        cam_left, cam_right, rect, sgbm = load_pfiles(
            left_cam_file, right_cam_file, rect_file, sgbm_file)
        return cls(cam_left["K"], cam_left["dist"], cam_right["K"],
                   cam_right["dist"], rect, sgbm, img_size, device=device)

    @classmethod
    def from_npz(cls, path, img_size, device="cuda"):
        """Calibration from an npz with K_left, dist_left, K_right,
        dist_right, R, T and sgbm_<key> entries."""
        with np.load(path, allow_pickle=False) as z:
            sgbm = {k: int(z[f"sgbm_{k}"]) for k in SGBM_KEYS}
            return cls(z["K_left"], z["dist_left"], z["K_right"],
                       z["dist_right"], {"R": z["R"], "T": z["T"]}, sgbm,
                       img_size, device=device)

    def __init__(self, K_left, dist_left, K_right, dist_right, rect_params,
                 sgbm_params, img_size, device="cuda"):
        """``img_size`` is (width, height); ``sgbm_params`` is the
        reference's dict or an SGBMParams; ``device`` holds the maps and
        runs the per-frame path: the card unless the caller passes
        ``device="cpu"`` (raises where no card is present)."""
        self.device = target_device(device)
        self.img_size = (int(img_size[0]), int(img_size[1]))
        R1, R2, P1, P2, Q, roi_l, roi_r = stereo_rectify(
            K_left, dist_left, K_right, dist_right, self.img_size,
            rect_params["R"], rect_params["T"])
        self.R1, self.R2, self.P1, self.P2 = R1, R2, P1, P2
        self.Q = Q
        self.valid_region_left = roi_l
        self.valid_region_right = roi_r

        def to_dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        maps_l = init_undistort_rectify_map(K_left, dist_left, R1, P1,
                                            self.img_size)
        maps_r = init_undistort_rectify_map(K_right, dist_right, R2, P2,
                                            self.img_size)
        self.map_left = tuple(map(to_dev, maps_l))
        self.map_right = tuple(map(to_dev, maps_r))
        self._remap_left = make_remap(*self.map_left)
        self._remap_right = make_remap(*self.map_right)

        if isinstance(sgbm_params, SGBMParams):
            self.sgbm = sgbm_params
        else:
            self.sgbm = _sgbm_params_from_dict(sgbm_params)

        x, y, rw, rh = self.valid_region_left
        self.crop_slice = (slice(y, rh), slice(x, rw))
        self.cropped_shape = (max(rh - y, 0), max(rw - x, 0))
        self._q_dev = to_dev(Q)

    # -- per-frame ops ------------------------------------------------------

    def _remap(self, maps, img):
        """The JAX camera's eager rectification: op by op, without the
        fused multiply-adds of its jitted path (``compute_3d`` keeps those,
        through ``make_remap``)."""
        img = torch.as_tensor(img, device=self.device)
        if img.dtype == torch.uint8:
            return remap_u8(img, *maps)
        return remap_bilinear(img, *maps)

    def undistort_rectify_left(self, img):
        """Rectify one left frame; uint8 in gives uint8 out, as cv2.remap."""
        return self._remap(self.map_left, img)

    def undistort_rectify_right(self, img):
        """Rectify one right frame; uint8 in gives uint8 out."""
        return self._remap(self.map_right, img)

    def crop_to_valid_region_left(self, img):
        x, y, w, h = self.valid_region_left
        return img[y:h, x:w]

    def crop_to_valid_region_right(self, img):
        x, y, w, h = self.valid_region_right
        return img[y:h, x:w]

    def compute_3d_fn(self, color: bool, preprocessed: bool):
        """The function (imgL, imgR) -> (img_3d, disparity, img_left), all
        cropped, on the camera's device. Invalid disparity (the
        minDisparity - 1 marker) reprojects to inf, so the inf-aware
        sampler drops it. A batch of pairs ((B, H, W), or (B, H, W, 3)
        with ``color``) gives each output a leading frame axis, from one
        launch of each SGBM kernel."""
        remap_l, remap_r, q = self._remap_left, self._remap_right, self._q_dev
        params = self.sgbm
        sl = self.crop_slice

        def fn(img_left, img_right):
            if color:
                img_left = bgr_to_gray(img_left)
                img_right = bgr_to_gray(img_right)
            img_left = img_left.to(torch.float32)
            img_right = img_right.to(torch.float32)
            if not preprocessed:
                img_left = remap_l(img_left)
                img_right = remap_r(img_right)
            disparity = sgbm_disparity(img_left, img_right, params)
            img_3d = reproject_image_to_3d(disparity, q)
            valid = disparity >= (params.min_disparity - 0.75)
            img_3d = torch.where(valid[..., None], img_3d, float("inf"))
            return (img_3d[..., sl[0], sl[1], :],
                    disparity[..., sl[0], sl[1]], img_left[..., sl[0], sl[1]])

        return fn

    def compute_3d(self, img_left, img_right, preprocessed: bool = False):
        """(img_3d, disparity, img_left) for one pair, on the device.

        On the card (unless ``_graph.disable_capture()`` is active) each
        call replays a CUDA graph captured on the first call per (color,
        preprocessed, the inputs' shapes and dtypes), as JAX jits the
        function per (color, preprocessed); the outputs are copies of the
        graph's, so a later call leaves an earlier result as it was, as
        JAX returns fresh arrays."""
        img_left, img_right = torch.as_tensor(img_left), torch.as_tensor(
            img_right)
        color = img_left.ndim == 3
        if self.device.type != "cuda" or not capture_enabled():
            fn = self.compute_3d_fn(color, preprocessed)
            return fn(img_left.to(self.device), img_right.to(self.device))
        key = (color, preprocessed) + tuple(
            (tuple(x.shape), x.dtype) for x in (img_left, img_right))
        cache = self.__dict__.setdefault("_compute_3d_cache", {})
        if key not in cache:
            fn = self.compute_3d_fn(color, preprocessed)
            cache[key] = capture(lambda _, left, right: ((), *fn(left, right)),
                                 self.device)
        _, *outs = cache[key]((), img_left, img_right)
        return tuple(x.clone() for x in outs)
