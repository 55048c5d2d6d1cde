"""Device helpers.

The port's entry points run on the CUDA device unless the caller passes
``device=`` (``device="cpu"`` for the plain versions on the CPU), and
without a card they raise rather than run on the CPU: the simulators
(``UltrasoundSystem.greens``, ``simus``, ``calc_scat_all``,
``calc_scat_multi``, ``calc_hp``, ``das_delay_tables`` and the ``ops``
functions behind them) and the beamformers (``DAS``, ``bfDAS``,
``bfDASLUT``, ``bfAdjoint``, ``focusTx``, ``refocus``, ``bfMigration``),
which move their traces there, and ``kspaceFirstOrder`` with the
functions of ``ops/fdbf.py``, ``ops/rays.py`` (its device path) and
``sim/fdtd.py`` behind them.
Every other function, ``ChannelData``'s methods among them, computes on
the device of its input tensor.
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
            f"device {str(dev)!r} (the default of the port's entry points) needs a "
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


def tensor_on(x, device=None) -> torch.Tensor:
    """``x`` (a tensor, numpy, or any array numpy reads, a JAX array among
    them) as a tensor on ``device`` (None: the CUDA device, raising without
    one; :func:`default_device`). uint16 arrays, the TPU package's
    bf16-bits trace wire format, raise ``ValueError``."""
    dev = default_device(device)
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.as_tensor(a if a.flags.writeable else a.copy())
    if x.dtype == torch.uint16:
        raise ValueError("uint16 traces are the TPU package's bf16-bits wire format "
                         "(_upload_trace; ROADMAP 'Not to port'); pass float32 or complex64")
    return x.to(dev)


def refuse_tpu_contracts(out: str = "complex", interpret: bool = False) -> None:
    """Raise ``ValueError`` for the TPU package's transfer contracts that the
    kernel-level entry points take and the port does not (ROADMAP "Not to
    port"): ``out='ri'`` and ``interpret=True``."""
    if out == "ri":
        raise ValueError("out='ri' is the TPU package's real/imaginary transfer contract "
                         "(ROADMAP 'Not to port'); the port returns complex64")
    if out != "complex":
        raise ValueError(f"unknown out {out!r}; expected 'complex'")
    if interpret:
        raise ValueError("interpret=True is a Pallas kernel's CPU emulation (ROADMAP 'Not to "
                         "port'); pass device='cpu' for the plain versions")
