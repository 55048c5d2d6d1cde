"""Device helpers.

The simulators (``UltrasoundSystem.greens``, ``simus``, ``calc_scat_all``,
``calc_scat_multi``, ``calc_hp``, ``das_delay_tables`` and the ``ops``
functions behind them) run on the CUDA device unless the caller passes
``device=`` (``device="cpu"`` for the plain versions on the CPU); without a
card they raise rather than run on the CPU. Every other function computes
on the device of its input tensor.
"""
from __future__ import annotations

import numpy as np
import torch

# On the CPU, torch's float sqrt, sin, cos, exp and log run MKL's vector
# math in chunks of 2048 elements over the intra-op threads. When a
# process's first such call runs on several threads at once, one worker's
# chunk can come back with relative errors up to 3e-4 (torch 2.13.0+cpu
# with MKL 2024.2: 5 of 640 fresh processes; none of 440 after this call),
# which moved the plain DAS's receive distances by ~9 um. One call of one
# chunk, on the importing thread, sets MKL up first.
torch.sqrt(torch.ones(16))


def is_cuda(t) -> bool:
    """True when ``t`` is a tensor on a CUDA device."""
    return isinstance(t, torch.Tensor) and t.is_cuda


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the CUDA device, the
    simulators' default. Raises ``RuntimeError`` when the result is a CUDA
    device and this machine has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} (the default of the port's simulators) needs a "
            "CUDA card and none is available; pass device='cpu' to run the "
            "plain versions on the CPU")
    return dev


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
