"""Multi-camera rig batching, PyTorch port of ``openvo_tpu/parallel/rig.py``:
N independent stereo odometers advanced together, the cameras a leading
batch axis of every tensor of the step.

JAX maps the whole step over the cameras with ``jax.vmap`` and jits it
with the state donated (``openvo_tpu/parallel/rig.py:45-46``). Here the
step takes the (N, H, W) batch itself: ``extract`` runs each kernel and
plain stage once for the N cameras, and ``step_feats`` runs each camera's
state machine on its own (the fallback attempt computed for every camera,
each taking its own branch). On the card ``RigOdometer.update`` replays
the step as one CUDA graph (``openvo_tpu_torch/_graph.py``), its one sync
the copy of the results. The pose filters, when on, take the N cameras'
point clouds at once: the rigid clique's kernel H8 runs a block for each
cloud, and the rig's step is captured with them as without them.

All cameras share calibration (the synthetic-rig case), as in the JAX
package.
"""

from __future__ import annotations

import numpy as np

from openvo_tpu_torch import trace
from openvo_tpu_torch._graph import capture, capture_enabled
from openvo_tpu_torch.config import OdometerConfig
from openvo_tpu_torch.models.stereo_odometer import (FrameFeatures,
                                                     OdomState,
                                                     init_state, make_step,
                                                     make_update_fn,
                                                     run_update,
                                                     unpack_stats)


def make_rig_step(camera, cfg: OdometerConfig, color: bool = False):
    """Batched step: (states, imgsL (N,H,W), imgsR) -> (states', oks, stats).
    The odometer's step takes a leading camera axis as it stands."""
    return make_step(camera, cfg, color)


def init_rig_state(camera, cfg: OdometerConfig, n_cameras: int) -> OdomState:
    """The initial state of ``n_cameras`` odometers on the camera's
    device: every tensor of the one-camera state with a leading axis."""
    one = init_state(camera.cropped_shape, cfg.orb.max_keypoints,
                     camera.device)

    def batch(x):
        return x.expand((n_cameras,) + x.shape).clone()

    return OdomState(FrameFeatures(*map(batch, one.cur)),
                     FrameFeatures(*map(batch, one.prev)),
                     *map(batch, one[2:]))


class RigOdometer:
    """N independent odometers advanced by one batched step on the
    camera's device (the card unless the camera was built with
    ``device="cpu"``). On the card the step is one replayed CUDA graph
    unless capture is disabled;
    ``captured`` says how the last update ran, and ``graph`` is the
    captured step."""

    def __init__(self, camera, n_cameras: int,
                 config: OdometerConfig | None = None):
        self.camera = camera
        self.config = config or OdometerConfig()
        self.n_cameras = n_cameras
        self.device = camera.device
        self._state = init_rig_state(camera, self.config, n_cameras)
        self._update = make_update_fn(camera, self.config, False)
        self.graph = (capture(self._update) if self.device.type == "cuda"
                      else None)
        self.captured = None
        self.last_stats = {}

    @property
    def state(self) -> OdomState:
        """The cameras' state; on a captured rig the graph's static
        buffers, which the next update overwrites: copy what you keep."""
        return self._state

    def update(self, imgs_left, imgs_right):
        """imgs_*: (N, H, W). Returns per-camera success flags (N,) bool;
        ``last_stats`` holds each camera's step statistics. Its one host
        sync is the copy of the results. Traced as ``ovo.update``
        (``openvo_tpu_torch/trace.py``)."""
        with trace.span("ovo.update"):
            with trace.span("ovo.prepare"):
                self.captured = self.graph is not None and capture_enabled()
                step = self.graph if self.captured else self._update
            self._state, vals = run_update(step, self._state,
                                           (imgs_left, imgs_right),
                                           self.device)
            with trace.span("ovo.unpack"):
                vals = vals.numpy()
                self.last_stats = unpack_stats(vals)
                return vals[0].astype(bool)

    def current_poses(self):
        """(N, 4, 4) float64 camera-in-world poses, inv(c_T_w)."""
        return np.linalg.inv(self._state.c_T_w.cpu().numpy().astype(
            np.float64))
