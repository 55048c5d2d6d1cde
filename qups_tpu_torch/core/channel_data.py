"""Echo (channel) data container.

Port of :class:`qups_tpu.core.channel_data.ChannelData`: a tensor ``data``
of echo traces with axes ``(T, N, M, *F)`` (time samples, receive elements,
transmits, then frame dims), a scalar sampling frequency ``fs``, and a
per-transmit start time ``t0`` broadcastable against the non-time dims. The
time axis is ``t = t0 + arange(T)/fs``.

``data`` stays on whatever device it was given, and every method computes
on that device (they are the container's tensor methods; the beamformers
move the traces to the card). ``t0`` is host metadata (a float or a
float32 numpy array). The DSP surface (``hilbert``, ``downmix``,
``resample``, the filters, ``join`` and the rest) follows the JAX
package's, FFTs by ``torch.fft`` as the JAX package leaves them to XLA;
trailing frame dims pass through every method. The JAX package's
``_ddata`` (its complex-upload workaround for the TPU) has no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.conv import convd
from ..ops.interp import (bshape_left, expand_trailing, interp1, interpf,
                          wsinterpd, wsinterpd2)

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
        """Time axis ``t0 + (0:T-1)'/fs`` shaped (T, 1, [1|M], 1, ...), one
        dim per data dim, float32 on the data's device. ``t0`` aligns with
        the data's leading dims (the JAX package broadcasts it from the
        right, which puts a per-transmit t0 on the last frame dim)."""
        nd = self.data.ndim
        n = torch.arange(self.T, dtype=torch.float32, device=self.data.device
                         ).reshape((-1,) + (1,) * (nd - 1))
        return expand_trailing(self._t0_dev(), nd) + n / self.fs

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
        return torch.as_tensor(np.array(self.t0, np.float32),
                               device=self.data.device)

    def _minus_t0(self, tau: torch.Tensor) -> torch.Tensor:
        """``tau - t0``, the two aligned on their leading dims (trailing
        singletons), as ``time`` aligns them. Where both have the same
        number of dims, as the JAX package's callers give them, this is its
        ``tau - t0``."""
        t0 = self._t0_dev()
        nd = max(tau.ndim, t0.ndim)
        return expand_trailing(tau, nd) - expand_trailing(t0, nd)

    # -------------------------------------------------------------- sampling
    def sample(self, tau, method: str = "cubic", w=None, sdim=None,
               fmod: float = 0.0):
        """Sample the data at times ``tau`` (seconds, absolute), applying
        weights ``w``, summing over dims ``sdim`` and remodulating at
        ``fmod``: ``y = sum_sdim w * exp(2j pi fmod (tau - t0)) *
        x((tau - t0) fs)``. ``method='freq'`` is the Fourier interpolant
        (:func:`qups_tpu_torch.ops.interp.interpf`), whose phasor and
        weights broadcast as ordinary (right-aligned) tensors, as in the JAX
        package."""
        fs = float(np.float32(self.fs))
        ntau = self._minus_t0(torch.as_tensor(tau, device=self.data.device)
                              .to(torch.float32)) * fs
        omega = 2 * np.pi * fmod / self.fs
        if method == "freq":
            v = interpf(self.data, ntau)
            if fmod:
                th = omega * ntau
                v = v * torch.polar(torch.ones_like(th), th)
            if w is not None:
                v = v * torch.as_tensor(w, device=self.data.device)
            if sdim is not None:
                sdims = (sdim,) if isinstance(sdim, int) else tuple(sdim)
                v = torch.sum(v, dim=sdims, keepdim=True)
            return v
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
            n1, n2 = self._minus_t0(t1) * fs, t2 * fs
        else:
            n1, n2 = t1 * fs, self._minus_t0(t2) * fs
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

    # ------------------------------------------------------------------- DSP
    def astype(self, dtype) -> "ChannelData":
        """The traces as ``dtype`` (a torch dtype, or a numpy one)."""
        return self.replace(data=self.data.to(_torch_dtype(dtype)))

    def downmix(self, fc: float) -> "ChannelData":
        """Demodulate by ``fc``: multiply by ``exp(-2j pi fc t)``."""
        th = -2 * np.pi * fc * self.time
        return self.replace(data=self.data * torch.polar(torch.ones_like(th), th))

    def hilbert(self) -> "ChannelData":
        """Analytic signal along the time axis (of the real part)."""
        T = self.T
        X = torch.fft.fft(_real(self.data), dim=0)
        h = np.zeros(T)
        h[0] = 1
        if T % 2 == 0:
            h[T // 2] = 1
            h[1:T // 2] = 2
        else:
            h[1:(T + 1) // 2] = 2
        hsh = torch.as_tensor(h, dtype=torch.float32, device=X.device
                              ).reshape((-1,) + (1,) * (self.data.ndim - 1))
        return self.replace(data=torch.fft.ifft(X * hsh, dim=0))

    def get_passband_filter(self, bw: Tuple[float, float], order: int = 64) -> torch.Tensor:
        """Linear-phase FIR bandpass (Hamming window method), float32 on
        the data's device."""
        lo, hi = bw
        return self._tensor(_fir_design(order, self.fs, lo=lo, hi=hi))

    def get_lowpass_filter(self, cutoff: float, order: int = 64) -> torch.Tensor:
        """Linear-phase FIR lowpass (Hamming window method), float32 on the
        data's device."""
        return self._tensor(_fir_design(order, self.fs, lo=None, hi=cutoff))

    def _tensor(self, a) -> torch.Tensor:
        """An array or tensor as a tensor on the data's device, 64-bit
        values rounded to 32 bits (the JAX package runs without float64)."""
        a = torch.as_tensor(a, device=self.data.device)
        return a.to(_NARROW[a.dtype]) if a.dtype in _NARROW else a

    def _kernel(self, h) -> torch.Tensor:
        """Filter taps as a tensor (L, 1, ...) against the data."""
        return self._tensor(h).reshape((-1,) + (1,) * (self.data.ndim - 1))

    def filter(self, h) -> "ChannelData":
        """Causal FIR filter along time; ``t0`` moves back by the filter's
        group delay, so a linear-phase filter keeps the echoes in time."""
        h = self._kernel(h)
        d = convd(self.data, h, axis=0, shape="full")
        return self.replace(data=d, t0=self.t0 - (h.shape[0] - 1) / 2 / self.fs)

    def filtfilt(self, h) -> "ChannelData":
        """Zero-phase forward-backward filtering."""
        h = self._kernel(h)
        hh = convd(h, torch.flip(h.conj().resolve_conj(), dims=(0,)), axis=0,
                   shape="full")
        d = convd(self.data, hh, axis=0, shape="full")
        return self.replace(data=d, t0=self.t0 - (hh.shape[0] - 1) / 2 / self.fs)

    def fft(self, n: Optional[int] = None) -> torch.Tensor:
        return torch.fft.fft(self.data, n=n, dim=0)

    def fftaxis(self, n: Optional[int] = None) -> np.ndarray:
        n = n or self.T
        return np.fft.fftfreq(n) * self.fs

    def downsample(self, k: int) -> "ChannelData":
        return self.replace(data=self.data[::k], fs=self.fs / k)

    def resample(self, fs_new: float, method: str = "cubic") -> "ChannelData":
        """Resample to a new rate over the same time window (the new
        ``ceil(T fs_new / fs)`` samples from the same ``t0``)."""
        ratio = fs_new / self.fs
        Tn = int(np.ceil(self.T * ratio))
        ntau = (torch.arange(Tn, dtype=torch.float32, device=self.data.device)
                / ratio).reshape((-1,) + (1,) * (self.data.ndim - 1))
        return self.replace(data=interp1(self.data, ntau, method=method), fs=fs_new)

    def convt(self, wv_samples, lag0: float = 0.0) -> "ChannelData":
        """Convolve along time with a sampled kernel; ``t0`` moves by the
        kernel's start time ``lag0``."""
        d = convd(self.data, self._kernel(wv_samples), axis=0, shape="full")
        return self.replace(data=d, t0=self.t0 + lag0)

    def estfc(self) -> float:
        """The center frequency estimated from the spectral peak."""
        mag = self.fft().abs().reshape(self.T, -1).sum(dim=1)
        return float(np.abs(self.fftaxis())[int(mag.argmax())])

    def rectifyt0(self, method: str = "cubic") -> "ChannelData":
        """Resample every trace onto one time axis starting at the least
        ``t0``, which becomes scalar."""
        t0 = self.t0_host
        if t0.size == 1:
            return self.replace(t0=float(t0[0]))
        t0min = float(t0.min())
        nd = self.data.ndim
        # the shifts in samples (>= 0), aligned with the data's leading dims
        nshift = np.asarray(self.t0, np.float64).reshape(
            (1,) * max(0, 3 - np.ndim(self.t0)) + np.shape(self.t0))
        nshift = (nshift.reshape(nshift.shape + (1,) * (nd - nshift.ndim)) - t0min) * self.fs
        Tn = self.T + int(np.ceil(nshift.max()))
        i = np.arange(Tn).reshape((-1,) + (1,) * (nd - 1))
        ntau = torch.as_tensor((i - nshift).astype(np.float32), device=self.data.device)
        return self.replace(data=interp1(self.data, ntau, method=method), t0=t0min)

    def align_int(self, method: str = "cubic") -> "ChannelData":
        """Resample to a time axis on integer multiples of ``1 / fs``."""
        c = self.rectifyt0(method=method)
        t0 = float(c.t0_host[0])
        n0 = math.ceil(t0 * c.fs)
        frac = n0 / c.fs - t0
        i = np.arange(c.T).reshape((-1,) + (1,) * (c.data.ndim - 1))
        ntau = torch.as_tensor((i + frac * c.fs).astype(np.float32), device=c.data.device)
        return c.replace(data=interp1(c.data, ntau, method=method), t0=n0 / c.fs)

    # ------------------------------------------------------------ structure
    def join(self, others: Sequence["ChannelData"], axis: int = 3) -> "ChannelData":
        """Concatenate along a trailing (frame) dim. The result keeps this
        object's ``t0`` and ``fs``, as in the JAX package: bring the others
        to the same time axis first."""
        chds = [self, *others]
        nd = max(max(c.data.ndim for c in chds), axis + 1)
        datas = [c.data.reshape(tuple(c.data.shape) + (1,) * (nd - c.data.ndim))
                 for c in chds]
        return self.replace(data=torch.cat(datas, dim=axis))

    def splice(self, axis: int = MDIM):
        """Split into one ``ChannelData`` per index of ``axis``, each keeping
        the dim, with the matching slice of ``t0``."""
        n = self.data.shape[axis]
        out = []
        for i in range(n):
            t0i = self.t0
            if np.ndim(t0i) > axis and np.shape(t0i)[axis] == n:
                sl = [slice(None)] * np.ndim(t0i)
                sl[axis] = slice(i, i + 1)
                t0i = t0i[tuple(sl)]
            out.append(self.replace(data=self.data.narrow(axis, i, 1), t0=t0i))
        return out

    def subt(self, start: int, stop: int) -> "ChannelData":
        """Samples ``start:stop`` of the time axis; ``t0`` follows."""
        return self.replace(data=self.data[start:stop], t0=self.t0 + start / self.fs)

    # ------------------------------------------------------------ arithmetic
    def _binop(self, other, op):
        if isinstance(other, ChannelData):
            other = other.data
        elif not isinstance(other, (int, float, complex)):
            other = self._tensor(other)
        return self.replace(data=op(self.data, other))

    def __add__(self, o): return self._binop(o, torch.add)
    def __sub__(self, o): return self._binop(o, torch.sub)
    def __mul__(self, o): return self._binop(o, torch.mul)
    def __truediv__(self, o): return self._binop(o, torch.true_divide)
    def __neg__(self): return self.replace(data=-self.data)

    def txmul(self, H) -> "ChannelData":
        """Matrix product over the transmit dim: ``y[t, n, v, ...] =
        sum_m H[v, m] x[t, n, m, ...]``."""
        H = self._tensor(H)
        dt = torch.promote_types(H.dtype, self.data.dtype)
        return self.replace(data=torch.einsum("vm,tnm...->tnv...", H.to(dt),
                                              self.data.to(dt)))

    def real(self): return self.replace(data=_real(self.data))

    def imag(self):
        d = self.data
        return self.replace(data=d.imag if d.is_complex() else torch.zeros_like(d))

    def abs(self): return self.replace(data=self.data.abs())
    def conj(self): return self.replace(data=self.data.conj().resolve_conj())

    @property
    def is_complex(self) -> bool:
        return self.data.is_complex()


# 64-bit host values and the 32-bit types the JAX package computes them in
_NARROW = {torch.float64: torch.float32, torch.complex128: torch.complex64}


def _real(d: torch.Tensor) -> torch.Tensor:
    return d.real if d.is_complex() else d


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _fir_design(order: int, fs: float, lo: Optional[float], hi: Optional[float]) -> np.ndarray:
    """Hamming-window FIR design (lowpass, or bandpass when ``lo`` is
    given) of odd length, float64 numpy: a copy of the JAX package's, whose
    values it gives to the bit."""
    L = int(order) | 1  # odd
    n = np.arange(L) - (L - 1) / 2
    sinc = lambda fc: 2 * fc / fs * np.sinc(2 * fc / fs * n)  # noqa: E731
    h = sinc(hi) if lo is None else sinc(hi) - sinc(lo)
    h = h * np.hamming(L)
    # passband gain ~1
    if lo is None:
        h = h / h.sum()
    else:
        f0 = (lo + hi) / 2
        g = np.abs(np.sum(h * np.exp(-2j * np.pi * f0 / fs * np.arange(L))))
        h = h / max(g, np.finfo(float).tiny)
    return h
