"""``rot2RPY``, the openVO API's Euler-angle helper (numpy in and out),
over :func:`openvo_tpu_torch.geometry.se3.rot2rpy`."""

from __future__ import annotations

import numpy as np

from openvo_tpu_torch.geometry.se3 import rot2rpy


def rot2RPY(T):
    """(roll, pitch, yaw) of the rotation in the top-left 3x3 of ``T``, each
    a (2, 1) float64 numpy array holding both Euler branches."""
    return tuple(v.numpy() for v in rot2rpy(np.asarray(T, dtype=np.float64)))
