"""Serialization and checkpoints.

Port of :mod:`qups_tpu.io`. ``ChannelData`` round-trips through ``.npz``
with the JAX package's keys (complex traces as a trailing real/imaginary
pair), so a file written by either package loads in the other; the port
writes it uncompressed (``np.savez``), which ``np.load`` reads as it reads
the JAX package's compressed files. Checkpoints are ``torch.save`` files
where the JAX package uses orbax; :func:`obj2dict` / :func:`dict2obj` turn
the domain objects into plain dicts and back (the ``.mat`` round trip of
:mod:`qups_tpu_torch.interop` rides on them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .core.channel_data import ChannelData
from .utils.backend import to_host


def save_chd(path: str, chd: ChannelData) -> None:
    """Save ChannelData to ``.npz`` (complex stored as a trailing ri pair);
    traces on any device are copied to the host."""
    data = to_host(chd.data)
    cplx = np.iscomplexobj(data)
    if cplx:
        data = np.stack([data.real, data.imag], axis=-1)
    np.savez(path, data=data, fs=chd.fs, t0=np.asarray(chd.t0_host), cplx=cplx)


def load_chd(path: str, device=None) -> ChannelData:
    """Load a :func:`save_chd` file (of either package). The traces stay on
    the host unless ``device`` names one, as ``ChannelData`` keeps its
    data where it was given."""
    with np.load(path) as z:
        data, fs, t0, cplx = z["data"], float(z["fs"]), z["t0"], bool(z["cplx"])
    if cplx:
        data = data[..., 0] + 1j * data[..., 1]
    x = torch.from_numpy(np.ascontiguousarray(data))
    if device is not None:
        x = x.to(device)
    return ChannelData(data=x, fs=fs, t0=float(t0[0]) if t0.size == 1 else t0)


# numpy leaves ride in a checkpoint as tensors under this key, so that
# ``torch.load(weights_only=True)`` takes the file and gives numpy back
_NUMPY = "__qups_numpy__"


def _encode(tree):
    if isinstance(tree, (np.ndarray, np.generic)):
        return {_NUMPY: torch.from_numpy(np.array(tree)),
                "scalar": isinstance(tree, np.generic)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encode(v) for v in tree)
    return tree


def _decode(tree, like):
    if isinstance(tree, dict) and _NUMPY in tree:
        a = tree[_NUMPY].numpy()
        tree = a[()] if tree["scalar"] else a
    if isinstance(tree, dict):
        return {k: _decode(v, like.get(k) if isinstance(like, dict) else None)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        lk = like if isinstance(like, (list, tuple)) else (None,) * len(tree)
        return type(tree)(_decode(v, w) for v, w in zip(tree, lk))
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(tree).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return np.asarray(to_host(tree), like.dtype)
    return tree


def save_checkpoint(path: str, tree: Any) -> None:
    """Checkpoint a tree (dicts, lists, tuples) of tensors, numpy arrays and
    scalars into one ``torch.save`` file; tensors on a card are copied to
    the host. Overwrites ``path``."""
    torch.save(_encode(tree), path)


def load_checkpoint(path: str, like: Any = None) -> Any:
    """Restore a :func:`save_checkpoint` tree with
    ``torch.load(weights_only=True)``. Numpy leaves come back as numpy and
    tensors on the host; with ``like``, a template tree, each leaf takes the
    device and dtype of ``like``'s leaf at the same place (a tensor there
    puts it on that tensor's device)."""
    return _decode(torch.load(path, map_location="cpu", weights_only=True), like)


def obj2dict(obj: Any) -> Dict:
    """Dataclass -> plain dict with a class tag (``obj2struct`` analog).
    Callables (waveform functions, region predicates) are dropped: they
    are code, not data. A tensor field becomes host numpy, numpy arrays
    become lists, as in the JAX package."""
    d = {"class": type(obj).__name__}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if callable(v):
            continue
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = obj2dict(v)
        elif isinstance(v, torch.Tensor):
            v = to_host(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        d[f.name] = v
    return d


def dict2obj(d: Dict):
    """Rebuild a domain object (``qups_tpu_torch.core``) or an
    ``UltrasoundSystem`` from :func:`obj2dict` output."""
    from . import core

    d = dict(d)
    name = d.pop("class")
    if hasattr(core, name):
        cls = getattr(core, name)
    else:
        from . import system as _system
        cls = getattr(_system, name)
    kw = {}
    for k, v in d.items():
        if isinstance(v, dict) and "class" in v:
            v = dict2obj(v)
        kw[k] = v
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kw.items() if k in names})
