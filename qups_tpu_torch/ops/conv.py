"""Batched 1-D convolution along one axis.

Port of :func:`qups_tpu.ops.conv.convd` and ``xcorr``, with convd's two
methods: ``"direct"``
(a sliding multiply-add over the kernel taps, for short kernels) and
``"fft"`` (an FFT product, for long ones). Output shapes are
``full | same | valid`` with the same lag bookkeeping.
"""
from __future__ import annotations

import torch


def conv_lag0(nx: int, ny: int, shape: str) -> int:
    """Starting lag into the full convolution for an output shape."""
    if shape == "full":
        return 0
    if shape == "same":
        return (ny - 1) // 2
    if shape == "valid":
        return ny - 1
    raise ValueError(shape)


def conv_len(nx: int, ny: int, shape: str) -> int:
    return {"full": nx + ny - 1, "same": nx, "valid": max(0, nx - ny + 1)}[shape]


def convd(x: torch.Tensor, y: torch.Tensor, axis: int = 0, shape: str = "full",
          method: str = "auto") -> torch.Tensor:
    """Convolve ``x`` with ``y`` along ``axis``; other dims broadcast.

    The result's ``axis`` has length ``conv_len(nx, ny, shape)``; the other
    dims are the broadcast of the operands' batch dims.
    """
    nd = x.ndim
    xm = torch.movedim(x, axis, -1)
    ym = torch.movedim(y, axis, -1)
    nx, ny = xm.shape[-1], ym.shape[-1]
    if method == "auto":
        method = "direct" if min(nx, ny) <= 64 else "fft"
    nfull = nx + ny - 1
    if method == "fft":
        full = torch.fft.ifft(torch.fft.fft(xm, n=nfull, dim=-1)
                              * torch.fft.fft(ym, n=nfull, dim=-1), dim=-1)
        if not (xm.is_complex() or ym.is_complex()):
            full = full.real.to(torch.promote_types(xm.dtype, ym.dtype))
    elif method == "direct":
        # full[l] = sum_k a[l - k] * b[k], with a the longer operand
        a, b = (xm, ym) if ny <= nx else (ym, xm)
        nb = b.shape[-1]
        z = a.new_zeros(tuple(a.shape[:-1]) + (nb - 1,))
        ap = torch.cat([z, a, z], dim=-1)
        acc = None
        for k in range(nb):
            seg = ap[..., nb - 1 - k: nb - 1 - k + nfull]  # a view
            term = seg * b[..., k: k + 1]
            acc = term if acc is None else acc + term
        full = acc
    else:
        raise ValueError(f"unknown method {method!r}")
    l0 = conv_lag0(nx, ny, shape)
    out = full[..., l0: l0 + conv_len(nx, ny, shape)]
    return torch.movedim(out, -1, axis % nd if nd else 0)


def xcorr(x: torch.Tensor, y: torch.Tensor, axis: int = 0, shape: str = "full",
          method: str = "auto") -> torch.Tensor:
    """Cross-correlation ``x (*) conj(reverse(y))`` along ``axis``."""
    return convd(x, torch.flip(y.conj().resolve_conj(), dims=(axis,)), axis=axis,
                 shape=shape, method=method)
