"""The rigid clique's greedy-loop kernel H8 (``csrc/clique.cu``).

JAX grows the rigid clique in a ``lax.while_loop`` on the device
(``openvo_tpu/pose/rigid_clique.py:53-69``). H8 runs that loop in one
launch, one block a point cloud (up to 512 points the block packs the
matrix's columns into shared-memory bits and one warp runs the chain of
picks), with no host read, so a captured CUDA graph holds it. Its plain version is ``pose/rigid_clique.
greedy_clique_plain`` (the loop in batches of ``CHECK_EVERY`` steps between
host checks); ``pose/rigid_clique.rigid_body_filter`` reaches either
through the ``openvo_torch::greedy_clique`` operator, which takes the plain
version on a CPU tensor and H8 on a CUDA one.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch import _build
from openvo_tpu_torch.ops._dispatch import check_cuda_input, stream_handle

MAX_POINTS = 4096   # indices a block holds: 4 a thread, 1024 threads


def greedy_clique(cons, num):
    """H8: the greedy clique of (N, N) or (B, N, N) bool consistency
    matrices ``cons`` with their counts ``num`` (int32, num[j] = sum_i
    cons[i, j]), as (N,) or (B, N) int32 0/1 membership: JAX's loop from
    the seed argmax(num), picking argmax(num * (compatible - clique)) with
    ties to the first, while sum(compatible - clique) > 0 and fewer than N
    steps ran. Each cloud runs in its own block, so a member of a batch
    stops on its own condition.

    Raises on a CPU tensor (the operator routes those to the plain
    version) and above MAX_POINTS points."""
    dev = cons.device
    if dev.type != "cuda":
        raise ValueError(f"greedy_clique: the kernel needs CUDA tensors, got "
                         f"{dev}")
    if cons.ndim not in (2, 3):
        raise ValueError(f"cons: {cons.ndim} axes, expected (N, N) or "
                         f"(B, N, N)")
    n = cons.shape[-1]
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"greedy_clique: {n} points, the kernel takes 1 to "
                         f"{MAX_POINTS}")
    lead = tuple(cons.shape[:-2])
    check_cuda_input(cons, torch.bool, lead + (n, n), "cons")
    check_cuda_input(num, torch.int32, lead + (n,), "num")
    out = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    clouds = lead[0] if lead else 1
    err = _build.library().ovo_greedy_clique(
        cons.data_ptr(), num.data_ptr(), out.data_ptr(), clouds, n,
        stream_handle(dev))
    greedy_clique.launches += 1
    _build.check_launch(err, "greedy_clique")
    return out


greedy_clique.launches = 0

KERNELS = (greedy_clique,)
