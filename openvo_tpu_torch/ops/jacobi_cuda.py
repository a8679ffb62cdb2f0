"""The pose fits' kernels H10 and H11 (``csrc/jacobi.cu``).

JAX leaves the Kabsch fit and its SVDs to XLA under jit (no Pallas kernel):

- H10 ``kabsch_fit``: the whole Kabsch fit (``openvo_tpu/pose/kabsch.py:
  22-60``, its ``jnp.linalg.svd`` ``:49``), one block a fit: the masked
  sums as fixed pairwise trees over the points (threads over the points,
  then shared memory and shuffles), then on one thread JACOBI_SWEEPS
  sweeps of one-sided Jacobi on H, the cyclic shift of the least column,
  R = V U^T, t and the float32 4x4 (plain version
  ``pose/kabsch.kabsch_fit_plain``); one launch in place of the fit's ~30;
- H11 ``jacobi_svd``: a batched one-sided Jacobi SVD in float64 of
  matrices up to 9x9 (``openvo_tpu/pose/fivepoint.py:210``;
  ``ransac.py:140``, ``:142``, ``:273``), a group of n lanes a matrix,
  each lane a column in registers, the pairs in the round-robin order of
  ``pose/kabsch.jacobi_rounds`` (disjoint pairs rotated at once), each
  matrix stopping when a sweep rotates nothing (plain version
  ``pose/kabsch.jacobi_svd_plain``, which runs every sweep); a wide
  float32 matrix first through LAPACK's float32 LQ as JAX's SVD runs it on
  the CPU, a lane a row, so the five-point null space is JAX's basis bit
  for bit. ``torch.linalg.svd`` on the card checks its convergence on the
  host; H11 reads nothing back, so the mono step can be captured as one
  CUDA graph.

``pose/kabsch`` reaches both through the operators
``openvo_torch::kabsch_fit`` and ``openvo_torch::jacobi_svd``, which take
the plain versions on a CPU tensor and these kernels on a CUDA one.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch import _build
from openvo_tpu_torch.ops._dispatch import check_cuda_input, stream_handle

MAX_DIM = 9   # rows and columns of H11's matrices (csrc/jacobi.cu kMaxDim)
# H10's points a fit: 256 threads of up to 64 points each (csrc/jacobi.cu
# kFitThreads, kFitMaxLogK)
MAX_FIT_POINTS = 256 << 6


def _on_card(t, name):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got "
                         f"{t.device}")


def kabsch_fit(src, dst, mask):
    """H10: the (B, 4, 4) float32 Kabsch fits of float32 clouds ``src`` to
    ``dst`` (B, N, 3) over the rows where the bool ``mask`` (B, N) holds,
    one block a fit, bit-equal to ``pose/kabsch.kabsch_fit_plain``. N at
    most MAX_FIT_POINTS. Raises on a CPU tensor (the operator routes those
    to the plain version)."""
    _on_card(src, "kabsch_fit")
    if src.ndim != 3 or src.shape[-1] != 3:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected "
                         f"(B, N, 3)")
    B, N, _ = src.shape
    if N > MAX_FIT_POINTS:
        raise ValueError(f"kabsch_fit: {N} points, the kernel takes at most "
                         f"{MAX_FIT_POINTS}")
    check_cuda_input(src, torch.float32, (B, N, 3), "src")
    check_cuda_input(dst, torch.float32, (B, N, 3), "dst")
    check_cuda_input(mask, torch.bool, (B, N), "mask")
    if dst.device != src.device or mask.device != src.device:
        raise ValueError("kabsch_fit: src, dst and mask on one card")
    T = torch.empty((B, 4, 4), dtype=torch.float32, device=src.device)
    if B:
        err = _build.library().ovo_kabsch_fit(
            src.data_ptr(), dst.data_ptr(), mask.data_ptr(), T.data_ptr(),
            B, N, stream_handle(src.device))
        kabsch_fit.launches += 1
        _build.check_launch(err, "kabsch_fit")
    return T


kabsch_fit.launches = 0


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

KERNELS = (kabsch_fit, jacobi_svd)
