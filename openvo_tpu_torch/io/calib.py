"""Calibration files, port of ``openvo_tpu/io/calib.py``: the reference's
four pickle files (left/right camera {'K', 'dist'}, rect {'R', 'T'}, the
SGBM parameter dict), read by ``StereoCamera.from_pfiles``, and the
non-executable npz alternative, read by ``StereoCamera.from_npz``.
"""

from __future__ import annotations

import pickle

import numpy as np

SGBM_KEYS = (
    "minDisparity", "numDisparities", "blockSize", "P1", "P2",
    "disp12MaxDiff", "preFilterCap", "uniquenessRatio",
    "speckleWindowSize", "speckleRange",
)


def save_pfiles(prefix, K_left, dist_left, K_right, dist_right, R, T, sgbm):
    """Write the reference's four pickle files; returns their paths."""
    paths = {
        "left": f"{prefix}_left.p",
        "right": f"{prefix}_right.p",
        "rect": f"{prefix}_rect.p",
        "sgbm": f"{prefix}_sgbm.p",
    }
    contents = {
        "left": {"K": np.asarray(K_left), "dist": np.asarray(dist_left)},
        "right": {"K": np.asarray(K_right), "dist": np.asarray(dist_right)},
        "rect": {"R": np.asarray(R), "T": np.asarray(T)},
        "sgbm": {k: int(sgbm[k]) for k in SGBM_KEYS},
    }
    for name, path in paths.items():
        with open(path, "wb") as f:
            pickle.dump(contents[name], f)
    return paths


def load_pfiles(left_cam_file, right_cam_file, rect_file, sgbm_file):
    """The four pickles' contents: (cam_left, cam_right, rect, sgbm)."""
    out = []
    for path in (left_cam_file, right_cam_file, rect_file, sgbm_file):
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return tuple(out)


def save_npz(path, K_left, dist_left, K_right, dist_right, R, T, sgbm):
    """Write the calibration as one npz (no pickle); returns ``path``."""
    arrays = {
        "K_left": np.asarray(K_left), "dist_left": np.asarray(dist_left),
        "K_right": np.asarray(K_right), "dist_right": np.asarray(dist_right),
        "R": np.asarray(R), "T": np.asarray(T),
    }
    for k in SGBM_KEYS:
        arrays[f"sgbm_{k}"] = np.asarray(int(sgbm[k]))
    np.savez(path, **arrays)
    return path
