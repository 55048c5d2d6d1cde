"""Carry state across from the JAX package.

:func:`from_reference` turns a :mod:`qups_tpu` domain object into the
port's counterpart of the same class name, so that both packages compute on
the same state. It walks the dataclass fields and reads every array field
with ``np.asarray``, which takes a JAX array as it is: this module never
imports JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_CLASSES = (
    "Fused", "Waveform", "Transducer", "TransducerArray", "TransducerConvex",
    "TransducerMatrix", "TransducerGeneric", "Sequence", "SequenceRadial",
    "SequenceGeneric", "ScanCartesian", "ScanPolar", "ScanSpherical",
    "ScanGeneric", "Scatterers", "ChannelData", "UltrasoundSystem", "Medium",
)


def _counterpart(obj):
    import qups_tpu_torch

    name = type(obj).__name__
    if name not in _CLASSES or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no counterpart in qups_tpu_torch for {name}")
    return getattr(qups_tpu_torch, name)


def _value(v, memo):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return from_reference(v, memo)
    if v is None or callable(v) or isinstance(v, (str, bool, int, float, tuple)):
        return v
    return np.asarray(v)


def from_reference(obj, _memo=None):
    """The port's counterpart of ``obj``, a ``qups_tpu`` ``Transducer*``,
    ``Sequence*``, ``Scan*``, ``Scatterers``, ``Waveform``, ``ChannelData``,
    ``Medium``, ``UltrasoundSystem`` or ``Fused`` apodization descriptor (its
    kind and parameters, an array parameter such as ``lat_tx`` as numpy).
    Shared sub-objects stay shared (a system whose ``tx is rx`` keeps that).
    A ``ChannelData``'s traces land on the CPU. Any sequence type (the FC
    sequence of ``calc_hp`` among them) and any waveform (its function is
    carried as it is, a complex pulse too) come across, and so does a
    ``Medium``'s tuple of perturbation regions, its mask and value
    callables carried as they are (host numpy in both packages).

    Example:
        import qups_tpu, qups_tpu_torch
        from qups_tpu_torch.convert import from_reference
        xdc = from_reference(qups_tpu.TransducerArray.L11_5v())
        assert isinstance(xdc, qups_tpu_torch.TransducerArray)
    """
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    cls = _counterpart(obj)
    if cls.__name__ == "Fused":  # its fields are (kind, params); it takes (kind, **params)
        out = memo[id(obj)] = cls(obj.kind, **{k: _value(v, memo) for k, v in obj.params})
        return out
    kw = {f.name: _value(getattr(obj, f.name), memo)
          for f in dataclasses.fields(obj) if f.init}
    out = cls(**kw)
    memo[id(obj)] = out
    return out
