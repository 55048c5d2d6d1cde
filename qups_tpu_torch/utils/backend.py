"""Device helpers.

The port never picks a device by itself: every function computes on the
device of its input tensor, or on an explicit ``device=`` argument.
"""
from __future__ import annotations

import numpy as np
import torch


def is_cuda(t) -> bool:
    """True when ``t`` is a tensor on a CUDA device."""
    return isinstance(t, torch.Tensor) and t.is_cuda


def as_f32(a, device) -> torch.Tensor:
    """Host geometry (float64 numpy) or a tensor, as float32 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    a = np.asarray(a, np.float32)
    return torch.as_tensor(a if a.flags.writeable else a.copy(), device=device)


def to_host(x) -> np.ndarray:
    """A tensor (any device) or array as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
