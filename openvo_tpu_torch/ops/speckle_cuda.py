"""The speckle filter's labelling kernel H7 (``csrc/speckle.cu``).

JAX labels the speckle filter's components with row and column min-scans
in a ``lax.while_loop`` that runs on the device until nothing changes
(``openvo_tpu/ops/sgbm.py:476-488``). H7 labels them by a block-based
union-find in four launches (32x32 tiles labelled in shared memory, the
edges across tiles united in global memory, roots and sizes a tile at a
time, keep), with no host read, so a captured CUDA graph holds it. Its plain version is
``ops/sgbm.speckle_keep_plain`` (hooking and pointer jumps until no edge
joins two labels, then ``torch.bincount``); ``ops/sgbm.speckle_filter``
reaches either through the ``openvo_torch::speckle_keep`` operator, which
takes the plain version on a CPU tensor and H7 on a CUDA one.
"""

from __future__ import annotations

import torch

from openvo_tpu_torch import _build
from openvo_tpu_torch.ops._dispatch import check_cuda_input, stream_handle

# flat indices are int32 in the kernel, with a block of threads to spare
MAX_PIXELS = 2 ** 31 - 1 - 256


def speckle_keep(disp, valid, max_diff: int, window: int):
    """H7: (labels, keep) of (H, W) or (B, H, W) disparities ``disp``
    (int16, or int32 as the row tiles gather them) and their ``valid``
    mask, on the card. labels (int32) is each pixel's component's smallest
    flat index ``b*H*W + y*W + x``, over 4-connected valid pixels whose
    disparities differ by at most ``max_diff`` (an invalid pixel is its own
    component); keep (bool) is ``valid & (component size > window)``. A
    batch is one flat index space with no edge across frames, so each
    frame gets its own call's components, offset by b*H*W.

    Raises on a CPU tensor (the operator routes those to the plain
    version) and where B*H*W does not fit the kernel's int32 indices."""
    dev = disp.device
    if dev.type != "cuda":
        raise ValueError(f"speckle_keep: the kernel needs CUDA tensors, got "
                         f"{dev}")
    if disp.ndim not in (2, 3):
        raise ValueError(f"disp: {disp.ndim} axes, expected (H, W) or "
                         f"(B, H, W)")
    if disp.dtype not in (torch.int16, torch.int32):
        raise TypeError(f"disp: dtype {disp.dtype}, expected int16 or int32")
    if disp.numel() > MAX_PIXELS:
        raise ValueError(f"speckle_keep: {disp.numel()} pixels exceed the "
                         f"kernel's int32 indices ({MAX_PIXELS})")
    shape = tuple(disp.shape)
    check_cuda_input(disp, disp.dtype, shape, "disp")
    check_cuda_input(valid, torch.bool, shape, "valid")
    labels = torch.empty(shape, dtype=torch.int32, device=dev)
    size = torch.empty(shape, dtype=torch.int32, device=dev)
    keep = torch.empty(shape, dtype=torch.bool, device=dev)
    H, W = shape[-2:]
    frames = shape[0] if len(shape) == 3 else 1
    err = _build.library().ovo_speckle_keep(
        disp.data_ptr(), int(disp.dtype == torch.int32), valid.data_ptr(),
        labels.data_ptr(), size.data_ptr(), keep.data_ptr(), frames, H, W,
        int(max_diff), int(window), stream_handle(dev))
    speckle_keep.launches += 1
    _build.check_launch(err, "speckle_keep")
    return labels, keep


speckle_keep.launches = 0

KERNELS = (speckle_keep,)
