"""The traffic generator: a textured corridor rendered through an ideal
stereo rig, on the device, from a seed.

A PyTorch copy of the corridor of ``openvo_tpu_torch/io/synthetic.py``
(four planes: a floor, two walls and a back wall; multi-octave value
noise; analytic ray-plane intersection; 2x supersampling), with the poses
of ``openvo_tpu_torch/tools/bench.py`` (0.5 m and 0.004 rad of yaw a frame
along an 80 m x 7 m corridor). The texture is drawn on the device from
the seed, one texture per camera of a rig, so every seed renders the same
amount of work with other content. The texture is ``texture_px`` texels on
a side at 60 texels a metre (the original's 1024: it repeats every 17 m).
"""

from __future__ import annotations

import numpy as np
import torch

# (cells across 1024 texels, amplitude) of each octave of the noise
OCTAVES = ((16, 1.0), (64, 0.9), (256, 0.7), (1024, 0.25))


def camera_seed(seed: int, camera: int) -> int:
    """The texture seed of one camera of a rig."""
    return (seed * 1_000_003 + camera) % 2 ** 63


def make_texture(seed: int, device, size: int = 1024,
                 octaves=OCTAVES) -> torch.Tensor:
    """(size, size) float32 value noise in [0, 255]: independent uniform
    octaves, each bilinearly upsampled, so every patch is unique. The
    octaves' cells keep their size in texels at any ``size`` (a larger
    texture is more of the same noise, not a coarser one)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tex = torch.zeros((size, size), dtype=torch.float32, device=device)
    for cells, amp in octaves:
        octave = min(max(cells * size // 1024, 1), size)
        coarse = torch.rand((octave, octave), generator=gen, device=device)
        if octave < size:
            idx = torch.linspace(0, octave - 1, size, dtype=torch.float64,
                                 device=device)
            i0 = idx.floor().to(torch.int64)
            i1 = (i0 + 1).clamp(max=octave - 1)
            f = (idx - i0).to(torch.float32)
            rows = coarse[i0] * (1 - f)[:, None] + coarse[i1] * f[:, None]
            up = rows[:, i0] * (1 - f)[None] + rows[:, i1] * f[None]
        else:
            up = coarse
        tex += amp * up
    tex -= tex.min()
    return tex * (255.0 / tex.max())


def corridor_planes(length: float, half_width: float):
    """(p0, normal, e1, e2, texture scale) of the floor, the walls and the
    back wall (camera y points down, the path runs along +z)."""
    return [((0, 1.2, 0), (0, -1, 0), (1, 0, 0), (0, 0, 1), 60.0),
            ((-half_width, 0, 0), (1, 0, 0), (0, 0, 1), (0, 1, 0), 60.0),
            ((half_width, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 1, 0), 60.0),
            ((0, 0, length), (0, 0, -1), (1, 0, 0), (0, 1, 0), 60.0)]


def trajectory(n: int, step: float, yaw_rate: float) -> np.ndarray:
    """(n, 4, 4) camera-to-world poses: forward ``step`` m and ``yaw_rate``
    rad a frame; frame 0 is the identity."""
    c, s = np.cos(yaw_rate), np.sin(yaw_rate)
    dT = np.eye(4)
    dT[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    dT[:3, 3] = [0, 0, step]
    poses = [np.eye(4)]
    for _ in range(1, n):
        poses.append(poses[-1] @ dT)
    return np.stack(poses)


def intrinsics(camera: dict) -> np.ndarray:
    """K of a configuration's ``camera`` group (OpenCV's convention: pixel
    centres at whole coordinates, as KITTI's P matrices)."""
    return np.array([[camera["fx"], 0, camera["cx"]],
                     [0, camera["fy"], camera["cy"]], [0, 0, 1.0]])


def _sample(tex, u, v):
    """Wrapped bilinear sample of ``tex`` at float64 coordinates."""
    size = tex.shape[0]
    uf, vf = u.floor(), v.floor()
    fu, fv = u - uf, v - vf
    u0 = uf.to(torch.int64) % size
    v0 = vf.to(torch.int64) % size
    u1, v1 = (u0 + 1) % size, (v0 + 1) % size
    return (tex[v0, u0] * (1 - fu) * (1 - fv) + tex[v0, u1] * fu * (1 - fv)
            + tex[v1, u0] * (1 - fu) * fv + tex[v1, u1] * fu * fv)


def render_views(K, T_wc, planes, tex, width, height, ss: int = 2):
    """(N, height, width) float32 images of the N camera-to-world poses
    ``T_wc`` (N, 4, 4), rendered at ``ss`` times the resolution and box
    averaged down."""
    dev = tex.device
    K2 = np.array(K, np.float64)
    K2[:2, :2] *= ss
    K2[0, 2] = ss * K[0, 2] + (ss - 1) / 2.0
    K2[1, 2] = ss * K[1, 2] + (ss - 1) / 2.0
    w, h = width * ss, height * ss
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                          torch.arange(w, dtype=torch.float64, device=dev),
                          indexing="ij")
    Kinv = torch.as_tensor(np.linalg.inv(K2), device=dev)
    rays_cam = torch.stack([u, v, torch.ones_like(u)], -1) @ Kinv.T
    T = torch.as_tensor(np.asarray(T_wc, np.float64), device=dev)
    rays = torch.einsum("hwj,nij->nhwi", rays_cam, T[:, :3, :3])
    o = T[:, None, None, :3, 3]
    best = torch.full(rays.shape[:-1], float("inf"), dtype=torch.float64,
                      device=dev)
    img = torch.zeros(rays.shape[:-1], dtype=torch.float64, device=dev)
    for p0, n, e1, e2, scale in planes:
        p0, n, e1, e2 = (torch.tensor(x, dtype=torch.float64, device=dev)
                         for x in (p0, n, e1, e2))
        denom = rays @ n
        s = ((p0 - o) @ n) / denom
        valid = (denom < -1e-9) & (s > 0.05) & (s < best)
        rel = o + rays * s[..., None] - p0
        shade = _sample(tex, (rel @ e1) * scale, (rel @ e2) * scale)
        img = torch.where(valid, shade, img)
        best = torch.where(valid, s, best)
    img = img.to(torch.float32).reshape(-1, height, ss, width, ss)
    return img.mean(dim=(2, 4))


def render_sequence(seed: int, camera: dict, motion: dict, cameras: int,
                    device, batch: int = 4):
    """uint8 (cameras, frames, H, W) left and right images of the corridor,
    every camera along the same poses with a texture of its own, and the
    (frames, 4, 4) poses. ``motion`` may give the noise's ``octaves``
    ([cells across 1024 texels, amplitude] each; default ``OCTAVES``) and a
    ``contrast`` about mid-grey (default 1), as a low-texture mix would."""
    W, H = camera["width"], camera["height"]
    K = intrinsics(camera)
    poses = trajectory(motion["frames"], motion["step_m"],
                       motion["yaw_rad"])
    right = np.eye(4)
    right[0, 3] = camera["baseline_m"]
    planes = corridor_planes(motion["corridor_length_m"],
                             motion["corridor_half_width_m"])
    out = torch.empty((2, cameras, len(poses), H, W), dtype=torch.uint8,
                      device=device)
    for c in range(cameras):
        tex = make_texture(camera_seed(seed, c), device,
                           motion["texture_px"],
                           motion.get("octaves", OCTAVES))
        contrast = motion.get("contrast", 1.0)
        if contrast != 1.0:
            tex = 127.5 + contrast * (tex - 127.5)
        for side, offset in enumerate((np.eye(4), right)):
            for a in range(0, len(poses), batch):
                views = render_views(K, poses[a:a + batch] @ offset, planes,
                                     tex, W, H)
                out[side, c, a:a + batch] = views.clamp(0, 255).to(
                    torch.uint8)
    return out[0], out[1], poses
