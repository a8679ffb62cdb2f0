"""SE(3) utilities, PyTorch port of ``openvo_tpu/geometry/se3.py``:
composition, rigid inverse, the rotation magnitude that replaces
``cv2.Rodrigues`` in the motion gate, (R, t) to a 4x4 transform, Rodrigues'
formula, and roll/pitch/yaw extraction."""

from __future__ import annotations

import torch

from openvo_tpu_torch.ops._dispatch import device_constant


def compose(T_ab, T_bc):
    """Left-compose 4x4 homogeneous transforms (matmul)."""
    return T_ab @ T_bc


def inverse(T):
    """Closed-form inverse of a rigid 4x4 transform: [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ t], dim=-1)
    bottom = device_constant((0.0, 0.0, 0.0, 1.0), T.device,
                             T.dtype).expand(T.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rotation_magnitude(R):
    """Rotation angle arccos((tr(R) - 1) / 2), clipped against fp drift."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(c)


def rt_to_T(R, t):
    """Stack R (..., 3, 3) and t (..., 3) into (..., 4, 4) homogeneous
    transforms."""
    t = t.reshape(R.shape[:-2] + (3, 1))
    top = torch.cat([R, t], dim=-1)
    bottom = R.new_zeros(R.shape[:-2] + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rodrigues_vec_to_R(rvec):
    """Axis-angle vectors (..., 3) -> rotation matrices (Rodrigues'
    formula); the identity at theta = 0."""
    rvec = torch.as_tensor(rvec)
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    k = rvec / torch.where(theta > 1e-12, theta, 1.0)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([torch.stack([zero, -kz, ky], dim=-1),
                     torch.stack([kz, zero, -kx], dim=-1),
                     torch.stack([-ky, kx, zero], dim=-1)], dim=-2)
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(th > 1e-12, R, eye)


def rot2rpy(T):
    """Roll, pitch and yaw of the rotation in ``T`` (..., >=3, >=3), in
    float64, both Euler branches, as the reference's rot2RPY:

    - pitch = atan2(-R20, +-cos_theta) with cos_theta = sqrt(R00^2 + R10^2),
      roll and yaw divided by cos(pitch) per branch;
    - gimbal lock (cos_theta < 1e-4): both branches are pitch = -R20 pi/2,
      roll = R20 atan2(-R01, R11), yaw = 0.

    Returns (roll, pitch, yaw), each of shape (..., 2, 1)."""
    R = torch.as_tensor(T, dtype=torch.float64)[..., :3, :3]
    r00, r01 = R[..., 0, 0], R[..., 0, 1]
    r10, r11 = R[..., 1, 0], R[..., 1, 1]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    cos_theta = torch.sqrt(r00**2 + r10**2)
    locked = cos_theta < 1e-4

    def branch(c):
        pitch = torch.atan2(-r20, c)
        cp = torch.cos(pitch)
        return (torch.atan2(r21 / cp, r22 / cp), pitch,
                torch.atan2(r10 / cp, r00 / cp))

    locked_rpy = (r20 * torch.atan2(-r01, r11), -r20 * (torch.pi / 2.0),
                  torch.zeros_like(r20))
    both = [tuple(torch.where(locked, lk, v) for lk, v in zip(locked_rpy, b))
            for b in (branch(cos_theta), branch(-cos_theta))]
    return tuple(torch.stack([b0, b1], dim=-1)[..., :, None]
                 for b0, b1 in zip(*both))
