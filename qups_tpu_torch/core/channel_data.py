"""Echo (channel) data container.

Port of the container part of :class:`qups_tpu.core.channel_data.ChannelData`:
a tensor ``data`` of echo traces with axes ``(T, N, M, *F)`` (time samples,
receive elements, transmits, then frame dims), a scalar sampling frequency
``fs``, and a per-transmit start time ``t0`` broadcastable against the
non-time dims. The time axis is ``t = t0 + arange(T)/fs``.

``data`` stays on whatever device it was given; ``t0`` is host metadata
(a float or a float32 numpy array). Of the DSP methods, ``sample`` and
``sample2sep`` (the time-domain samplers of ``focusTx``) are ported; the
rest (hilbert, downmix, ...) are not yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from ..ops.interp import bshape_left, wsinterpd, wsinterpd2

TDIM, NDIM, MDIM = 0, 1, 2


@dataclass(frozen=True)
class ChannelData:
    data: torch.Tensor          # (T, N, M, *F)
    fs: float = 1.0             # sampling frequency [Hz]
    t0: Union[float, np.ndarray] = 0.0  # broadcastable to (1, N|1, M|1, *F)

    def __post_init__(self):
        d = self.data
        if not isinstance(d, torch.Tensor):
            a = np.asarray(d)
            d = torch.as_tensor(a if a.flags.writeable else a.copy())
        if d.ndim < 3:
            raise ValueError(f"data must be at least (T, N, M), got {tuple(d.shape)}")
        object.__setattr__(self, "data", d)
        t0 = self.t0
        if isinstance(t0, (int, float)):
            t0 = float(t0)
        else:
            if isinstance(t0, torch.Tensor):
                t0 = t0.detach().cpu().numpy()
            t0 = np.asarray(t0, dtype=np.float32)
            while 0 < t0.ndim < 3 and t0.size > 1:
                t0 = t0[None]  # lift vector t0 to (1, 1, M)-style
        object.__setattr__(self, "t0", t0)

    # ------------------------------------------------------------ properties
    @property
    def T(self) -> int: return self.data.shape[TDIM]
    @property
    def N(self) -> int: return self.data.shape[NDIM]
    @property
    def M(self) -> int: return self.data.shape[MDIM]
    @property
    def shape(self): return tuple(self.data.shape)

    @property
    def time(self) -> torch.Tensor:
        """Time axis ``t0 + (0:T-1)'/fs`` shaped (T, 1, [1|M], ...), float32
        on the data's device."""
        n = torch.arange(self.T, dtype=torch.float32, device=self.data.device
                         ).reshape((-1,) + (1,) * (self.data.ndim - 1))
        return self._t0_dev() + n / self.fs

    @property
    def tend(self):
        return self.t0 + (self.T - 1) / self.fs

    @property
    def t0_host(self) -> np.ndarray:
        """t0 as a flat float64 host array."""
        return np.asarray(self.t0, np.float64).reshape(-1)

    def replace(self, **changes) -> "ChannelData":
        return dataclasses.replace(self, **changes)

    def _t0_dev(self) -> torch.Tensor:
        """t0 as a float32 tensor on the data's device (its host shape)."""
        return torch.as_tensor(np.asarray(self.t0, np.float32),
                               device=self.data.device)

    # -------------------------------------------------------------- sampling
    def sample(self, tau, method: str = "cubic", w=None, sdim=None,
               fmod: float = 0.0):
        """Sample the data at times ``tau`` (seconds, absolute), applying
        weights ``w``, summing over dims ``sdim`` and remodulating at
        ``fmod``: ``y = sum_sdim w * exp(2j pi fmod (tau - t0)) *
        x((tau - t0) fs)``. ``method='freq'`` (Fourier interpolation) is not
        ported: ``UltrasoundSystem.focusTx`` does not reach it (ROADMAP
        Queue 1 item 8)."""
        if method == "freq":
            raise NotImplementedError(
                "ChannelData.sample(method='freq') needs interp.interpf, not "
                "ported yet (ROADMAP Queue 1 item 8)")
        fs = float(np.float32(self.fs))
        ntau = (torch.as_tensor(tau, device=self.data.device).to(torch.float32)
                - self._t0_dev()) * fs
        omega = 2 * np.pi * fmod / self.fs
        return wsinterpd(self.data, ntau, w=w, sdim=sdim, omega=omega,
                         method=method)

    def sample2sep(self, tau1, tau2, method: str = "cubic", w=None, sdim=None,
                   fmod: float = 0.0):
        """Sample at separable times ``tau1 + tau2`` (seconds, absolute);
        the delay tensors broadcast, so nothing of their joint size is live
        beyond one slice of the summed dim. t0 is folded into the smaller
        of the two tensors, as the JAX package does."""
        dev = self.data.device
        fs = float(np.float32(self.fs))
        t0 = self._t0_dev()
        t1 = torch.as_tensor(tau1, device=dev).to(torch.float32)
        t2 = torch.as_tensor(tau2, device=dev).to(torch.float32)
        if np.prod(bshape_left(t1.shape, t0.shape), dtype=np.int64) \
                <= np.prod(bshape_left(t2.shape, t0.shape), dtype=np.int64):
            n1, n2 = (t1 - t0) * fs, t2 * fs
        else:
            n1, n2 = t1 * fs, (t2 - t0) * fs
        omega = 2 * np.pi * fmod / self.fs
        return wsinterpd2(self.data, n1, n2, w=w, sdim=sdim, omega=omega,
                          method=method)

    def zeropad(self, pre: int = 0, post: int = 0) -> "ChannelData":
        """Pad the time axis with zeros; ``t0`` moves back by ``pre``
        samples."""
        pre, post = int(pre), int(post)
        d = self.data
        out = d.new_zeros((pre + d.shape[0] + post,) + tuple(d.shape[1:]))
        out[pre:pre + d.shape[0]] = d
        return self.replace(data=out, t0=self.t0 - pre / self.fs)
