"""Device checks shared by the kernel wrappers."""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor


def target_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``. The port's entry points run on the
    card unless the caller asks for the CPU, so asking for CUDA where torch
    finds no card raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {dev}; pass device='cpu' to "
                           f"run on the CPU")
    return dev


def device_of(*tensors) -> torch.device:
    """The one device all ``tensors`` lie on; raises on a mismatch."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"device mismatch: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_cuda_input(t, dtype, shape, name: str) -> None:
    """Validate a tensor handed to a CUDA kernel."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_handle(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


_CONSTANTS = {}


def device_constant(values, device, dtype=torch.float32, *args):
    """The constant tensor of ``values`` on ``device``, built once per
    (values, device, dtype, args): per-frame code reads it without a
    host-to-device copy, which on the card would be a stream sync, and
    which a captured CUDA graph cannot hold (``openvo_tpu_torch/_graph.py``
    builds every constant in its warm-up run). ``values`` is a number,
    nested tuples, or a function that returns an array from ``args``
    (cached by identity, so a large table is not hashed on every call).
    A tensor made under a tracer's fake mode (``make_fx``) is not kept."""
    key = (values, torch.device(device), dtype, args)
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.as_tensor(values(*args) if callable(values) else values,
                            dtype=dtype, device=device)
        if not isinstance(t, FakeTensor):
            _CONSTANTS[key] = t
    return t
