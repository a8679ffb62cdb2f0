"""The small SVDs of the pose fits as kernels H10 and H11
(``csrc/jacobi.cu``).

JAX leaves these SVDs to ``jnp.linalg.svd`` under jit, which XLA runs as
an iterative device algorithm on the TPU (no Pallas kernel):

- H10 ``rotation_3x3``: Kabsch's 3x3 SVD (``openvo_tpu/pose/kabsch.py:49``)
  as the port runs it, JACOBI_SWEEPS sweeps of one-sided Jacobi and the
  cyclic shift of the least column (``pose/kabsch.rotation_3x3_plain``),
  one thread a matrix, one launch in place of about 400 elementwise ones;
- H11 ``jacobi_svd``: a batched one-sided Jacobi SVD in float64 of
  matrices up to 9x9 (``openvo_tpu/pose/fivepoint.py:210``;
  ``ransac.py:140``, ``:142``, ``:273``), one thread a matrix, each
  stopping when a sweep rotates nothing (plain version
  ``pose/kabsch.jacobi_svd_plain``, which runs every sweep); a wide
  float32 matrix first through LAPACK's float32 LQ as JAX's SVD runs it on
  the CPU, so the five-point null space is JAX's basis bit for bit.
  ``torch.linalg.svd`` on the card checks its convergence on the host; H11
  reads nothing back, so the mono step can be captured as one CUDA graph.

``pose/kabsch`` reaches both through the operators
``openvo_torch::rotation_3x3`` and ``openvo_torch::jacobi_svd``, which take
the plain versions on a CPU tensor and these kernels on a CUDA one.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch import _build
from openvo_tpu_torch.ops._dispatch import check_cuda_input, stream_handle

MAX_DIM = 9   # rows and columns a thread's matrix holds (csrc/jacobi.cu)


def _on_card(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got "
                         f"{t.device}")


def rotation_3x3(H):
    """H10: the factors (V, U^T) of the Kabsch rotation of finite float64
    (..., 3, 3) cross-covariances ``H``, each (..., 3, 3), bit-equal to
    ``pose/kabsch.rotation_3x3_plain``. Raises on a CPU tensor (the
    operator routes those to the plain version)."""
    _on_card(H, "rotation_3x3")
    if H.ndim < 2 or tuple(H.shape[-2:]) != (3, 3):
        raise ValueError(f"H: shape {tuple(H.shape)}, expected (..., 3, 3)")
    lead = tuple(H.shape[:-2])
    flat = H.reshape((-1, 3, 3))
    B = flat.shape[0]
    check_cuda_input(flat, torch.float64, (B, 3, 3), "H")
    V = torch.empty((B, 3, 3), dtype=torch.float64, device=H.device)
    Ut = torch.empty_like(V)
    if B:
        err = _build.library().ovo_rotation_3x3(
            flat.data_ptr(), V.data_ptr(), Ut.data_ptr(), B,
            stream_handle(H.device))
        rotation_3x3.launches += 1
        _build.check_launch(err, "rotation_3x3")
    return V.reshape(lead + (3, 3)), Ut.reshape(lead + (3, 3))


rotation_3x3.launches = 0


def jacobi_svd(a, tol: float, max_sweeps: int):
    """H11: (S, V, U, sweeps) of the one-sided Jacobi SVD of matrices ``a``
    (B, m, n), 1 <= m, n <= MAX_DIM, float64 where m >= n and float32
    where m < n (LAPACK's float32 LQ first), bit-equal to
    ``pose/kabsch.jacobi_svd_plain`` run with ``tol`` and ``max_sweeps``:
    S (B, n) descending, V (B, n, n), U (B, 3, 3) where m = n = 3 (else
    (B, 0, 0)), all float64, sweeps (B,) int32. Raises on a CPU tensor."""
    _on_card(a, "jacobi_svd")
    if a.ndim != 3:
        raise ValueError(f"a: {a.ndim} axes, expected (B, m, n)")
    B, m, n = a.shape
    if not (1 <= m <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"jacobi_svd: {m}x{n} matrices, the kernel takes "
                         f"1 to {MAX_DIM} rows and columns")
    check_cuda_input(a, torch.float32 if m < n else torch.float64,
                     (B, m, n), "a")
    dev = a.device
    S = torch.empty((B, n), dtype=torch.float64, device=dev)
    V = torch.empty((B, n, n), dtype=torch.float64, device=dev)
    U = torch.empty((B, 3, 3) if m == n == 3 else (B, 0, 0),
                    dtype=torch.float64, device=dev)
    sweeps = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        err = _build.library().ovo_jacobi_svd(
            a.data_ptr(), S.data_ptr(), V.data_ptr(),
            U.data_ptr() if U.numel() else None, sweeps.data_ptr(), B, m, n,
            float(tol), int(max_sweeps), stream_handle(dev))
        jacobi_svd.launches += 1
        _build.check_launch(err, "jacobi_svd")
    return S, V, U, sweeps


jacobi_svd.launches = 0

KERNELS = (rotation_3x3, jacobi_svd)
