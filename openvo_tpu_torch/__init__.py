"""openvo_tpu_torch: the stereo visual-odometry system in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``openvo_tpu`` (which stays the reference), module
for module: ``config``, ``geometry``, ``io``, ``ops``, ``pose``, ``models``,
``parallel`` and ``utils`` keep the JAX package's names, and ``entry``
stands for the repo's ``__graft_entry__.py``. This package imports ``torch``
and never ``jax`` or ``openvo_tpu``.

Its API is the openVO reference's four exports (``StereoCamera``,
``StereoOdometer``, ``rot2RPY``, ``drawPoseOnImage``) and the config
dataclasses, as ``openvo_tpu`` exports them.

On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches its kernel (built from ``csrc/`` at first use, see
``_build.py``) or raises.
"""

from openvo_tpu_torch.config import OdometerConfig, ORBParams, SGBMParams
from openvo_tpu_torch.models.stereo_camera import StereoCamera
from openvo_tpu_torch.models.stereo_odometer import StereoOdometer
from openvo_tpu_torch.utils.draw_pose import drawPoseOnImage
from openvo_tpu_torch.utils.rot2rpy import rot2RPY

__version__ = "0.1.0"

__all__ = [
    "StereoCamera",
    "StereoOdometer",
    "rot2RPY",
    "drawPoseOnImage",
    "OdometerConfig",
    "ORBParams",
    "SGBMParams",
]
