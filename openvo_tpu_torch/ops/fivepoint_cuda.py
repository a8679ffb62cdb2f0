"""The five-point solver's root stage, H12 (``csrc/fivepoint.cu``).

JAX leaves Nister's solver to XLA under jit (no Pallas kernel). After the
elimination, the port's plain version (``pose/fivepoint.
five_point_roots_plain``) runs B(z), its determinant, the 512-cell
sign-change scan, 48 bisection steps and the back-substitution as ~800
small ATen kernels; H12 ``five_point_roots`` runs them in one launch, a
block of 256 threads a sample (``openvo_tpu/pose/fivepoint.py:112-195``, the
``_real_roots`` fori_loop, and ``:217-240``, the back-substitution). Each
launch records the trace counter ``ovo.five_point_roots``, eagerly or at a
capture.

``pose/fivepoint.five_point_roots`` routes CPU tensors to the plain version
and CUDA tensors here.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch import _build, trace
from openvo_tpu_torch.ops._dispatch import check_cuda_input, stream_handle

ROOTS = 10   # candidate slots a sample (csrc/fivepoint.cu kRoots)


def five_point_roots(M, basis):
    """H12: (Es (S, 10, 3, 3) float32 at unit Frobenius norm, valid
    (S, 10) bool) from the eliminated system ``M`` (S, 10, 10) and the
    null-space basis (S, 4, 3, 3), both float32 and contiguous, bit-equal
    to ``pose/fivepoint.five_point_roots_plain`` run on the card for S >= 16
    (below, cuBLAS may take another order for the plain version's einsum).
    Raises on a CPU tensor (the route in ``pose/fivepoint`` takes the plain
    version there)."""
    if M.ndim != 3:
        raise ValueError(f"M: {M.ndim} axes, expected (S, 10, 10)")
    S = M.shape[0]
    check_cuda_input(M, torch.float32, (S, 10, 10), "M")
    check_cuda_input(basis, torch.float32, (S, 4, 3, 3), "basis")
    if M.device.type != "cuda" or basis.device != M.device:
        raise ValueError(f"five_point_roots: the kernel needs M and basis on "
                         f"one CUDA device, got {M.device} and "
                         f"{basis.device}")
    Es = torch.empty((S, ROOTS, 3, 3), dtype=torch.float32, device=M.device)
    valid = torch.empty((S, ROOTS), dtype=torch.bool, device=M.device)
    if S:
        err = _build.library().ovo_five_point_roots(
            M.data_ptr(), basis.data_ptr(), Es.data_ptr(), valid.data_ptr(),
            S, stream_handle(M.device))
        five_point_roots.launches += 1
        trace.count("ovo.five_point_roots")
        _build.check_launch(err, "five_point_roots")
    return Es, valid


five_point_roots.launches = 0

KERNELS = (five_point_roots,)
