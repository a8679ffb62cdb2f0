"""Constants of the plain reference on a device."""

from __future__ import annotations

import torch


def device_constant(values, device, dtype=torch.float32, *args):
    """The tensor of ``values`` (a number, nested tuples, or a function
    that returns an array from ``args``) on ``device``."""
    return torch.as_tensor(values(*args) if callable(values) else values,
                           dtype=dtype, device=device)
