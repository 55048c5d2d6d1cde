"""File import and export: Verasonics .mat workspaces, UFF (USTB) HDF5
files, and MATLAB .mat round trips of the port's objects.

Port of :mod:`qups_tpu.interop`, which is host numpy, ``scipy.io`` and
``h5py`` code; the port keeps its own copy, adapted to its objects. The
host arrays stay host numpy, and the traces of an imported acquisition
become a CPU ``torch.Tensor`` in the port's :class:`ChannelData` (a
beamformer moves them to the card). ``scipy`` and ``h5py`` are imported
inside the functions that need them, so the package imports without them.

* :func:`channel_data_from_verasonics` -- ``ChannelData.Verasonics``
  (QUPS ``src/ChannelData.m:241-434``): per-buffer parsing of
  ``RcvData``/``Receive``, with the sample-mode zero insertion and the
  channel-to-element map.
* :func:`transducer_from_verasonics` -- ``Transducer.Verasonics``
  (``src/Transducer.m:470-535``): linear, convex, matrix and generic
  arrays, wavelength or mm units, the IR1wy impulse.
* :func:`sequence_from_verasonics` -- ``Sequence.Verasonics``
  (``src/Sequence.m:613-837``): infers FSA / PW / FC / DV / VS from the TX
  struct, checks the parsed delays and apodization against the geometric
  model and takes the Vantage tables where they disagree, and returns the
  per-transmit t0 offset between the two delay conventions.
* :func:`scan_from_verasonics` -- ``Scan.Verasonics`` (``src/Scan.m:76-130``).
* :func:`waveform_from_verasonics` -- ``Waveform.Verasonics``
  (``src/Waveform.m:504-574``): 250 MHz sampled tri-level / 1-way / 2-way.
* :func:`load_verasonics` -- one-call import of a saved Vantage workspace.
* :func:`save_uff` / :func:`load_uff` -- UFF-style HDF5 files of a
  (ChannelData, Transducer, Sequence, Scan) bundle (the ``uff.channel_data``
  layout: 'class'/'name' attributes, complex data as real/imag pairs).
* :func:`save_mat` / :func:`load_mat` -- MATLAB v5 .mat round trip of any
  bundle of the port's objects through :func:`qups_tpu_torch.io.obj2dict`.

Files cross between the packages: a file either package writes, the other
reads.

UFF DIALECT ASSUMPTIONS (documented risk, as in the JAX package): every UFF
fixture of the tests is written by the tests themselves, to the conventions
read out of the reference importer:

1. 'class'/'name' node ATTRIBUTES identify types ('uff.channel_data',
   'uff.wave', 'uff.linear_scan', ...) and may be stored as str, bytes,
   or MATLAB uint16 char-code arrays (``src/ChannelData.m:86-116``); read
   case-insensitively (warning on non-canonical casing).
2. char DATASETS are uint16 code-point arrays with class='char'
   (``src/Sequence.m:560``).
3. complex values are groups holding 'real'/'imag' datasets with
   class='complex' (``src/ChannelData.m:128-141``).
4. arrays are column-major: MATLAB writes (F, M, N, T)-ordered
   channel data that h5py presents reversed; the reader permutes to
   (T, N, M, F) (``src/ChannelData.m:120-127``).
5. uff.wave children carry 'wavefront' enum codes / 'uff.wavefront.*'
   strings, 'source' uff.point groups (spherical azimuth/elevation/
   distance with optional xyz), and per-wave 'delay'
   (``src/Sequence.m:540-612``); FSA is detected by source == element
   positions, the t0 transform follows ``src/ChannelData.m:219-230``.
6. probe geometry under uff.linear_array/curvilinear_array/matrix_array
   properties ('pitch', 'N', 'radius', ...) in SI units
   (``src/Transducer.m:558-574``).
7. scalar properties may appear as 0-d datasets OR 1x1 arrays (MATLAB
   writes 1x1); all scalar reads squeeze.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .core.channel_data import ChannelData
from .core.scan import (Scan, ScanCartesian, ScanGeneric,
                        ScanPolar, ScanSpherical)
from .core.seq import Sequence, SequenceRadial, SequenceGeneric
from .core.waveform import Waveform
from .core.xdc import (Transducer, TransducerArray, TransducerConvex,
                       TransducerGeneric, TransducerMatrix)
from .utils.backend import to_host


# --------------------------------------------------------------------------
# Verasonics struct access helpers
# --------------------------------------------------------------------------
def _get(s, name, default=None):
    """Field access across scipy mat_struct / dict / object records."""
    if isinstance(s, dict):
        return s.get(name, default)
    return getattr(s, name, default)


def _has(s, name):
    return _get(s, name, None) is not None


def _asarr(v):
    return np.atleast_1d(np.squeeze(np.asarray(v)))


def _struct_list(S):
    """A Verasonics struct array as a python list of records."""
    if isinstance(S, (list, tuple)):
        return list(S)
    a = np.atleast_1d(np.asarray(S)).ravel()
    return list(a)


# --------------------------------------------------------------------------
# Transducer import (src/Transducer.m:470-535 + subclasses)
# --------------------------------------------------------------------------
def transducer_from_verasonics(Trans, c0: float = 1540.0) -> Transducer:
    """Construct a Transducer from a Verasonics 'Trans' struct."""
    fc = float(_get(Trans, "frequency")) * 1e6
    units = str(np.squeeze(np.asarray(_get(Trans, "units", "mm"))))
    scale = (c0 / fc) if units.startswith("wavelength") else 1e-3

    width = float(_get(Trans, "elementWidth", 0.0)) * scale
    if _has(Trans, "elementLength"):
        height = float(_get(Trans, "elementLength")) * scale
    elif _has(Trans, "elevationApertureMm"):
        height = float(_get(Trans, "elevationApertureMm")) * 1e-3
    else:
        height = width
    numel = int(_get(Trans, "numelements"))

    kw = dict(fc=fc, width=width, height=height, numel=numel)
    if _has(Trans, "Bandwidth"):
        bwv = _asarr(_get(Trans, "Bandwidth")) * 1e6
        kw["bw"] = (float(bwv[0]), float(bwv[-1]))

    ttype = int(_get(Trans, "type", 0))
    pos = _asarr(_get(Trans, "ElementPos", np.zeros((numel, 5))))
    pos = np.asarray(pos, np.float64).reshape(numel, -1)
    if ttype == 0:  # linear array (y = z = 0)
        if _has(Trans, "spacingMm"):
            pitch = float(_get(Trans, "spacingMm")) * 1e-3
        elif _has(Trans, "spacing"):
            pitch = float(_get(Trans, "spacing")) * (c0 / fc)
        else:
            pitch = float(np.mean(np.diff(pos[:, 0]))) * scale
        xdc = TransducerArray(pitch=pitch, **kw)
    elif ttype == 1:  # curved linear
        radius = float(_get(Trans, "radiusMm", 0.0)) * 1e-3
        if radius == 0.0 and _has(Trans, "radius"):
            radius = float(_get(Trans, "radius")) * (c0 / fc)
        # ElementPos col 3 is the azimuth angle [rad] on Vantage
        ang = pos[:, 3]
        dth = float(np.degrees(np.mean(np.diff(ang)))) if numel > 1 else 1.0
        xdc = TransducerConvex(radius=radius, angular_pitch=abs(dth), **kw)
    elif ttype in (2, 4):  # 2-D matrix / row-column
        x = np.unique(np.round(pos[:, 0] * scale, 9))
        y = np.unique(np.round(pos[:, 1] * scale, 9))
        nd = (max(1, x.size), max(1, y.size))
        px = float(np.mean(np.diff(x))) if x.size > 1 else width
        py = float(np.mean(np.diff(y))) if y.size > 1 else height
        xdc = TransducerMatrix(pitch2=(px, py), numd=nd, **kw)
    else:  # generic per-element positions
        p = (pos[:, :3] * scale).T
        az = np.degrees(pos[:, 3]) if pos.shape[1] > 3 else np.zeros(numel)
        el = np.degrees(pos[:, 4]) if pos.shape[1] > 4 else np.zeros(numel)
        xdc = TransducerGeneric(pos=tuple(map(tuple, p)), az=tuple(az),
                                el=tuple(el), **kw)

    # impulse response sampled at 250 MHz (``src/Transducer.m:522-528``)
    if _has(Trans, "IR1wy"):
        h = _asarr(_get(Trans, "IR1wy")).astype(np.float64)
        if h.size and np.any(h):
            env = np.abs(np.convolve(h, np.hanning(5) / 3, "same"))
            t0 = -float(np.argmax(env)) / 250e6
            xdc = xdc.replace(impulse=Waveform.from_samples(h, t0, 250e6))
    if _has(Trans, "elevationFocusMm"):
        xdc = xdc.replace(el_focus=float(_get(Trans, "elevationFocusMm")) * 1e-3)
    return xdc


# --------------------------------------------------------------------------
# Scan import (src/Scan.m:76-130)
# --------------------------------------------------------------------------
def scan_from_verasonics(PData, scale: float = 1.0) -> Scan:
    """Create a Scan from a Verasonics 'PData' struct (pixels scaled by
    ``scale`` — pass lambda = c0/fc to import in meters)."""
    coord = str(np.squeeze(np.asarray(_get(PData, "Coord", "rectangular"))))
    size_ = _asarr(_get(PData, "Size")).astype(int)
    pdelta = _asarr(_get(PData, "PDelta")).astype(np.float64)
    origin = _asarr(_get(PData, "Origin")).astype(np.float64)
    if coord == "rectangular":
        # Size = (rows=z, cols=x, pages=y); PDelta = (dx, dy, dz)
        nx, ny, nz = size_[1], size_[2], size_[0]
        dx, dy, dz = pdelta[0], pdelta[1], pdelta[2]
        x = origin[0] + 0.5 * dx + np.arange(nx) * dx
        y = origin[1] + np.arange(ny) * dy
        z = origin[2] + np.arange(nz) * dz
        return ScanCartesian(x=x * scale, y=y * scale, z=z * scale)
    if coord == "polar":
        r = np.arange(size_[0]) * pdelta[1]
        az = np.arange(size_[1]) * pdelta[0]
        y = np.arange(size_[2]) * (pdelta[2] if pdelta.size > 2 else 1.0)
        az = np.degrees(az - az.mean())
        return ScanPolar(origin=tuple(origin * scale), r=r * scale, a=az)
    if coord == "spherical":
        r = np.arange(size_[0]) * pdelta[0]
        az = np.degrees(np.arange(size_[1]) * pdelta[1])
        el = np.degrees(np.arange(size_[2]) * pdelta[2])
        return ScanSpherical(origin=tuple(origin * scale), r=r * scale,
                             a=az - az.mean(), e=el - el.mean())
    raise ValueError(f"unknown PData.Coord {coord!r}")


# --------------------------------------------------------------------------
# Waveform import (src/Waveform.m:504-574)
# --------------------------------------------------------------------------
def waveform_from_verasonics(TW, fc: Optional[float] = None,
                             which: str = "tri"):
    """Create Waveforms from a Verasonics 'TW' struct: ``which`` selects
    'tri' (voltage tri-level), '1wy' or '2wy'."""
    if fc is None:
        fc = float(_asarr(_get(TW, "Parameters"))[0]) * 1e6
    peak = float(_get(TW, "peak", 0.0))
    if which == "2wy":
        w = _asarr(_get(TW, "Wvfm2Wy"))
        t0 = -peak / fc
    elif which == "1wy":
        w = _asarr(_get(TW, "Wvfm1Wy"))
        t0 = -peak / fc / 2
    else:
        w = _get(TW, "TriLvlWvfm", None)
        if w is None:
            w = _get(TW, "TriLvlWvfm_Sim")
        w = _asarr(w)
        nz = np.flatnonzero(w)
        t0 = -float(np.median(nz)) / 250e6 if nz.size else 0.0
    return Waveform.from_samples(np.asarray(w, np.float64), t0, 250e6)


# --------------------------------------------------------------------------
# Sequence import (src/Sequence.m:613-837)
# --------------------------------------------------------------------------
def sequence_from_verasonics(TX, Trans, TW=None, c0: float = 1540.0,
                             xdc: Optional[Transducer] = None,
                             tol: Tuple[float, float] = (4e-9, 1e-9)):
    """Construct a Sequence from Verasonics 'TX' (+'Trans'[, 'TW']) structs.

    Returns ``(seq, t0)`` where t0 is the per-transmit offset between the
    Vantage and qups delay conventions (NaN when unverifiable)."""
    txs = _struct_list(TX)
    fc = float(_get(Trans, "frequency")) * 1e6
    lam = c0 / fc
    M = len(txs)
    numel = int(_get(Trans, "numelements"))

    apd = np.stack([np.resize(_asarr(_get(t, "Apod", [1.0])), numel)
                    for t in txs])                     # (M, N)
    tau = np.stack([np.resize(_asarr(_get(t, "Delay", [0.0])), numel)
                    for t in txs]) / fc                # (M, N) seconds
    ang = np.stack([np.resize(_asarr(_get(t, "Steer", [0.0, 0.0])), 2)
                    for t in txs])                     # (M, 2) radians
    rf = np.array([float(_get(t, "focus", 0.0)) for t in txs])  # lambda
    pog = np.stack([np.resize(_asarr(_get(t, "Origin", [0.0, 0, 0])), 3)
                    for t in txs])                     # (M, 3) lambda

    apdtx = apd.T  # (N, M)
    tautx = tau.T

    if xdc is None:
        try:
            xdc = transducer_from_verasonics(Trans, c0)
        except Exception:
            xdc = None

    # infer the sequence type (src/Sequence.m:718-793)
    if all(_has(t, "FocalPt") for t in txs) and \
            all(np.size(_get(t, "FocalPt")) for t in txs):
        pf = np.stack([np.resize(_asarr(_get(t, "FocalPt")), 3)
                       for t in txs]).T * lam  # (3, M)
        if isinstance(xdc, (TransducerArray, TransducerMatrix)):
            styp = "DV" if np.all(pf[2] < 0) else (
                "FC" if np.all(pf[2] > 0) else "VS")
        elif isinstance(xdc, TransducerConvex):
            r = np.linalg.norm(pf - np.asarray(xdc.center).reshape(3, 1),
                               axis=0)
            styp = "DV" if np.all(r < xdc.radius) else (
                "FC" if np.all(r > xdc.radius) else "VS")
        else:
            styp = "VS"
        seq = Sequence(type=styp, focus=pf, c0=c0)
    elif not np.any(tau):
        seq = Sequence(type="FSA", numpulse=M, c0=c0)
    elif np.all(rf == 0) and np.any(ang):
        az = np.degrees(ang[:, 0])
        seq = SequenceRadial(type="PW", angles=az, c0=c0)
    elif np.any(rf):
        dirs = np.stack([np.sin(ang[:, 0]) * np.cos(ang[:, 1]),
                         np.sin(ang[:, 1]),
                         np.cos(ang[:, 0]) * np.cos(ang[:, 1])], axis=1)
        pf = (pog + rf[:, None] * dirs).T * lam  # (3, M)
        styp = "FC" if np.all(rf > 0) else ("DV" if np.all(rf < 0) else "VS")
        seq = Sequence(type=styp, focus=pf, c0=c0)
    else:
        seq = SequenceGeneric(apd=apdtx, del_=tautx, numpulse=M, c0=c0)

    # validate apodization; override with Vantage values when they disagree
    if xdc is not None and not isinstance(seq, SequenceGeneric):
        try:
            aq = seq.apodization(xdc)
            if not np.allclose(apdtx, aq, atol=tol[1]):
                seq = dataclasses.replace(seq, apd=apdtx)
        except Exception:
            seq = dataclasses.replace(seq, apd=apdtx)

    # validate delays; compute the per-transmit t0 offset
    t0 = np.full(M, np.nan)
    if xdc is not None:
        try:
            tauq = seq.delays(xdc)  # (N, M)
            tauv = -tautx
            act = apdtx.astype(bool)
            qq = np.where(act, tauq, np.nan)
            vv = np.where(act, tauv, np.nan)
            with np.errstate(invalid="ignore"):
                t0 = np.nanmean(vv - qq, axis=0)
            if not np.allclose(np.where(act, vv, 0.0),
                               np.where(act, qq + t0[None, :], 0.0),
                               atol=tol[0]):
                seq = dataclasses.replace(seq, del_=tautx)
                t0 = np.full(M, np.nan)
        except Exception:
            seq = dataclasses.replace(seq, del_=tautx)

    if TW is not None:
        try:
            seq = dataclasses.replace(
                seq, pulse=waveform_from_verasonics(TW, fc))
        except Exception:
            pass
    return seq, t0


# --------------------------------------------------------------------------
# ChannelData import (src/ChannelData.m:241-434)
# --------------------------------------------------------------------------
_SAMPLE_MODES = {  # sample mode -> (insert N zeros, every K samples)
    "NS200BW": (0, 1), "BS100BW": (2, 2), "BS67BW": (2, 1), "BS50BW": (6, 2),
}


def channel_data_from_verasonics(RcvData, Receive, Trans=None, frames=None,
                                 buffer=None, insert0s: bool = True):
    """Construct ChannelData from Verasonics 'RcvData'/'Receive'
    (+'Trans') structs. Returns ``(chds, fmods, smodes)`` lists, one entry
    per receive buffer; data is ordered (T, N, M, F) = (time, elem/chan,
    acq, frame) — the reference's 'TMNF' order transposed to canonical."""
    rxs = _struct_list(Receive)
    bufnum = np.array([int(_get(r, "bufnum", 1)) for r in rxs])
    if buffer is None:
        buffer = list(dict.fromkeys(bufnum.tolist()))
    rcv = RcvData if isinstance(RcvData, (list, tuple)) else [RcvData]

    chds, fmods, smodes = [], [], []
    for i, b in enumerate(buffer):
        sel = [r for r, bn in zip(rxs, bufnum) if bn == b]
        if frames is not None:
            sel = [r for r in sel if int(_get(r, "framenum", 1)) in frames]
        if not sel:
            chds.append(None)
            fmods.append(np.nan)
            smodes.append("N/A")
            continue
        fs = float(_get(sel[0], "decimSampleRate", 0.0)) * 1e6
        fm = float(_get(sel[0], "demodFrequency", 0.0)) * 1e6
        fr = sorted({int(_get(r, "framenum", 1)) for r in sel})
        sm = {str(np.squeeze(np.asarray(_get(r, "sampleMode", "NS200BW"))))
              for r in sel}
        sm = sm.pop() if len(sm) == 1 else "N/A"
        F = len(fr)
        A = len(sel) // F
        # sample index span (identical across acquisitions)
        s0 = int(_get(sel[0], "startSample", 1)) - 1
        s1 = int(_get(sel[0], "endSample"))

        x = np.asarray(rcv[i])  # (samples, channels, frames)
        if x.ndim == 2:
            x = x[:, :, None]
        Tall = s1 - s0
        T = Tall // A if Tall % A == 0 else Tall
        # rows hold A acquisitions back to back (startSample per acq);
        # gather per-acquisition spans explicitly
        spans = sorted({(int(_get(r, "startSample", 1)) - 1,
                         int(_get(r, "endSample"))) for r in sel})
        T = spans[0][1] - spans[0][0]
        xacq = np.stack([x[a:bb] for (a, bb) in spans], axis=1)  # (T,A,C,F)
        if frames is not None:
            xacq = xacq[..., [f - 1 for f in fr]]

        # channel -> element mapping (src/ChannelData.m:376-409)
        if Trans is not None:
            numel = int(_get(Trans, "numelements"))
            if _has(sel[0], "aperture"):
                aps = np.asarray(_get(_get(Trans, "HVMux"), "ApertureES"))
                aps = aps.reshape(aps.shape[0], -1)
                a_of = np.array([int(_get(r, "aperture", 1)) for r in sel])
                a_of = a_of.reshape(-1, F)[:, 0]
            else:
                aps = np.asarray(_get(Trans, "ConnectorES")).reshape(-1, 1)
                a_of = np.ones(A, dtype=int)
            y = np.zeros(xacq.shape[:2] + (numel,) + xacq.shape[3:],
                         dtype=xacq.dtype)
            NCH = 256
            for a in np.unique(a_of):
                j = a_of == a
                k = aps[:, a - 1]
                kk = k != 0
                tmp = y[:, j]  # (T, nj, numel, F) copy; write back below
                tmp[:, :, kk] = xacq[:, j][:, :, (k[kk] - 1) % NCH]
                y[:, j] = tmp
            xacq = y

        # zero insertion per sample mode (src/ChannelData.m:417-427)
        if insert0s and sm in _SAMPLE_MODES:
            Nz, K = _SAMPLE_MODES[sm]
            if Nz:
                d = xacq.shape
                xr = xacq.reshape((K, d[0] // K) + d[1:], order="F")
                pad = np.zeros((Nz,) + xr.shape[1:], dtype=xacq.dtype)
                xr = np.concatenate([xr, pad], axis=0)
                xacq = xr.reshape(((K + Nz) * (d[0] // K),) + d[1:],
                                  order="F")

        # (T, A, C, F) -> canonical (T, N=chan/elem, M=acq, F), float32
        # on the host in C order (a CPU tensor that moves to a card in one copy)
        data = np.ascontiguousarray(np.moveaxis(xacq, 2, 1), dtype=np.float32)
        chds.append(ChannelData(data=data, fs=fs, t0=0.0))
        fmods.append(fm)
        smodes.append(sm)
    return chds, fmods, smodes


def load_verasonics(path, c0: Optional[float] = None):
    """Load a saved Verasonics Vantage workspace .mat file into the port's
    objects: returns a dict with any of 'chd' (list), 'xdc', 'seq', 'scan',
    'fmod', 'smode', 't0' that could be parsed
    (``UltrasoundSystem.Verasonics``, ``src/UltrasoundSystem.m:949``)."""
    from scipy.io import loadmat
    w = loadmat(path, squeeze_me=True, struct_as_record=False)
    out = {}
    Trans = w.get("Trans")
    if c0 is None:
        res = w.get("Resource")
        try:
            c0 = float(_get(_get(res, "Parameters"), "speedOfSound"))
        except Exception:
            c0 = 1540.0
    if Trans is not None:
        out["xdc"] = transducer_from_verasonics(Trans, c0)
        fc = float(_get(Trans, "frequency")) * 1e6
        if w.get("PData") is not None:
            out["scan"] = scan_from_verasonics(
                np.atleast_1d(w["PData"]).ravel()[0], c0 / fc)
        if w.get("TX") is not None:
            TW = w.get("TW")
            if TW is not None:
                TW = np.atleast_1d(TW).ravel()[0]
            out["seq"], out["t0"] = sequence_from_verasonics(
                w["TX"], Trans, TW, c0=c0)
    if w.get("RcvData") is not None and w.get("Receive") is not None:
        rcv = w["RcvData"]
        rcv = list(rcv) if isinstance(rcv, np.ndarray) and rcv.dtype == object \
            else [rcv]
        chd, fmod, smode = channel_data_from_verasonics(
            rcv, w["Receive"], Trans)
        out["chd"], out["fmod"], out["smode"] = chd, fmod, smode
    return out


# --------------------------------------------------------------------------
# UFF (USTB) HDF5 serialization
# --------------------------------------------------------------------------
def _uff_write_value(g, name, v):
    if isinstance(v, str):
        d = g.create_dataset(name, data=np.bytes_(v))
        d.attrs["class"] = np.bytes_("char")
    elif np.iscomplexobj(v):
        sub = g.create_group(name)
        sub.attrs["class"] = np.bytes_("complex")
        sub.create_dataset("real", data=np.real(v))
        sub.create_dataset("imag", data=np.imag(v))
    else:
        d = g.create_dataset(name, data=np.asarray(v))
        d.attrs["class"] = np.bytes_("single" if np.asarray(v).dtype ==
                                     np.float32 else "double")
    return g[name]


def save_uff(path, chd: Optional[ChannelData] = None,
             xdc: Optional[Transducer] = None,
             seq: Optional[Sequence] = None,
             scan: Optional[Scan] = None, name: str = "channel_data",
             us=None):
    """Write a UFF-style HDF5 file holding the bundle. The layout follows
    the USTB uff.channel_data convention (groups carry a 'class' attribute;
    complex arrays are real/imag pairs); geometry rides the uff.probe
    'geometry' matrix (``src/Transducer.m:442-467``).

    ``us``: optionally pass a whole :class:`UltrasoundSystem` — its
    rx transducer, sequence, and scan fill any of ``xdc``/``seq``/
    ``scan`` not given explicitly (the one-call bundle export the
    reference reaches through ``UltrasoundSystem.QUPS2USTB``,
    ``src/UltrasoundSystem.m:887-947``)."""
    import h5py
    if us is not None:
        xdc = xdc if xdc is not None else us.rx
        seq = seq if seq is not None else us.seq
        scan = scan if scan is not None else us.scan
    with h5py.File(path, "w") as f:
        f.attrs["version"] = np.bytes_("v1.2.0-qups-tpu")
        g = f.create_group(name)
        g.attrs["class"] = np.bytes_("uff.channel_data")
        if chd is not None:
            data = to_host(chd.data)
            _uff_write_value(g, "data", data)
            _uff_write_value(g, "sampling_frequency", float(chd.fs))
            t0 = np.asarray(chd.t0_host, np.float64)
            _uff_write_value(g, "initial_time", float(t0.reshape(-1)[0]))
            _uff_write_value(g, "t0", t0)
        if seq is not None:
            _uff_write_value(g, "sound_speed", float(seq.c0))
            sg = g.create_group("sequence")
            sg.attrs["class"] = np.bytes_("uff.wave")
            _uff_write_value(sg, "qups_type", seq.type)
            _uff_write_value(sg, "source_xyz", seq.focus_array.T)
            if seq.numpulse is not None:
                _uff_write_value(sg, "numpulse", int(seq.num_pulse))
        if xdc is not None:
            pg = g.create_group("probe")
            pg.attrs["class"] = np.bytes_({
                TransducerArray: "uff.linear_array",
                TransducerConvex: "uff.curvilinear_array",
                TransducerMatrix: "uff.matrix_array",
            }.get(type(xdc), "uff.probe"))
            az, el, _, _, _ = xdc.orientations()
            geom = np.concatenate([
                xdc.positions(),
                np.radians(np.broadcast_to(np.asarray(az, np.float64),
                                           (xdc.numel,)))[None],
                np.radians(np.broadcast_to(np.asarray(el, np.float64),
                                           (xdc.numel,)))[None],
                np.full((1, xdc.numel), xdc.width),
                np.full((1, xdc.numel), xdc.height)], axis=0)
            _uff_write_value(pg, "geometry", geom.T)  # (N, 7)
            _uff_write_value(pg, "fc", float(xdc.fc))
            _uff_write_value(pg, "bw", np.asarray(xdc.bw, np.float64))
            if isinstance(xdc, TransducerArray):
                _uff_write_value(pg, "pitch", float(xdc.pitch))
            if isinstance(xdc, TransducerConvex):
                _uff_write_value(pg, "radius", float(xdc.radius))
                _uff_write_value(pg, "angular_pitch", float(xdc.angular_pitch))
            if isinstance(xdc, TransducerMatrix):
                _uff_write_value(pg, "pitch2", np.asarray(xdc.pitch2))
                _uff_write_value(pg, "numd", np.asarray(xdc.numd))
        if scan is not None:
            sg = g.create_group("scan")
            if isinstance(scan, ScanCartesian):
                sg.attrs["class"] = np.bytes_("uff.linear_scan")
                _uff_write_value(sg, "x_axis", np.asarray(scan.x))
                _uff_write_value(sg, "y_axis", np.asarray(scan.y))
                _uff_write_value(sg, "z_axis", np.asarray(scan.z))
            elif isinstance(scan, ScanPolar):
                sg.attrs["class"] = np.bytes_("uff.sector_scan")
                _uff_write_value(sg, "depth_axis", np.asarray(scan.r))
                _uff_write_value(sg, "azimuth_axis",
                                 np.radians(np.asarray(scan.a)))
                _uff_write_value(sg, "origin", np.asarray(scan.origin))
            elif isinstance(scan, ScanSpherical):
                # USTB has no spherical class; the base uff.scan stores
                # explicit per-pixel xyz (``uff/scan.m``) — write those
                # plus the qups axes so our reader round-trips exactly
                sg.attrs["class"] = np.bytes_("uff.scan")
                P = scan.positions().reshape(3, -1)
                _uff_write_value(sg, "x", P[0])
                _uff_write_value(sg, "y", P[1])
                _uff_write_value(sg, "z", P[2])
                _uff_write_value(sg, "qups_type", "spherical")
                _uff_write_value(sg, "depth_axis", np.asarray(scan.r))
                _uff_write_value(sg, "azimuth_axis",
                                 np.radians(np.asarray(scan.a)))
                _uff_write_value(sg, "elevation_axis",
                                 np.radians(np.asarray(scan.e)))
                _uff_write_value(sg, "origin", np.asarray(scan.origin))
            else:
                # any other scan (ScanGeneric, subclasses): base uff.scan
                # with explicit per-pixel xyz
                sg.attrs["class"] = np.bytes_("uff.scan")
                P = np.asarray(scan.positions()).reshape(3, -1)
                _uff_write_value(sg, "x", P[0])
                _uff_write_value(sg, "y", P[1])
                _uff_write_value(sg, "z", P[2])
                _uff_write_value(sg, "qups_type", "generic")
                _uff_write_value(sg, "shape",
                                 np.asarray(scan.shape, np.int64))


def _uff_attr(node, name, default=""):
    """Decode an HDF5 attribute that may be str, bytes, or a MATLAB
    uint16 char-code array (USTB writes attrs via H5T_NATIVE char data)."""
    v = node.attrs.get(name, default)
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, str):
        return v
    a = np.asarray(v)
    if a.dtype.kind in "ui" and a.ndim >= 1:
        return "".join(chr(int(c)) for c in a.reshape(-1))
    if a.ndim == 0:
        return str(a)
    return "".join(str(x) for x in a.reshape(-1))


def _uff_class(node):
    """Node 'class' attribute, canonicalized: USTB writes lowercase class
    names; accept any casing with a warning (dialect-risk fallback)."""
    c = _uff_attr(node, "class")
    if c and not c.islower() and c.lower() != c:
        import warnings
        warnings.warn(f"UFF: non-canonical class attr casing {c!r}; "
                      "reading case-insensitively", stacklevel=3)
    return c.lower() if isinstance(c, str) else c


def _uff_read_value(node):
    import h5py
    if isinstance(node, h5py.Group):
        if _uff_class(node) == "complex" or \
                ("real" in node and "imag" in node):
            return np.asarray(node["real"]) + 1j * np.asarray(node["imag"])
        return {k: _uff_read_value(v) for k, v in node.items()}
    v = node[()]
    if isinstance(v, bytes):
        return v.decode()
    a = np.asarray(v)
    # USTB/MATLAB stores char arrays as uint16 code points
    if _uff_class(node) == "char" and a.dtype.kind in "ui":
        return "".join(chr(int(c)) for c in a.reshape(-1))
    return a


def _uff_point_xyz(pt):
    """uff.point dict -> cartesian xyz (USTB stores spherical
    azimuth/elevation/distance; xyz is the dependent form)."""
    if "xyz" in pt:
        return np.asarray(pt["xyz"], np.float64).reshape(-1)[:3]
    az = float(np.squeeze(pt.get("azimuth", 0.0)))
    el = float(np.squeeze(pt.get("elevation", 0.0)))
    d = float(np.squeeze(pt.get("distance", np.inf)))
    n = np.array([np.sin(az) * np.cos(el), np.sin(el),
                  np.cos(az) * np.cos(el)])
    return n if not np.isfinite(d) else d * n


def _seq_from_ustb_waves(waves, c0, elem_pos=None):
    """Map a list of uff.wave dicts to a Sequence + per-tx t0, following
    the reference's import rules (``Sequence.UFF``, ``src/Sequence.m:
    540-612``; t0 transform of ``ChannelData.UFF``,
    ``src/ChannelData.m:219-230``)."""
    wf = {str(np.squeeze(np.asarray(w.get("wavefront", 1)))) for w in waves}
    plane_codes = {"0", "uff.wavefront.plane", "plane"}
    pts = [w.get("source", {}) for w in waves]
    dists = np.array([float(np.squeeze(p.get("distance", np.inf)))
                      if isinstance(p, dict) else np.inf for p in pts])
    delay = np.array([float(np.squeeze(w.get("delay", 0.0))) for w in waves])
    if wf <= plane_codes or np.all(~np.isfinite(dists)):
        # plane waves: source encodes the steering direction
        dirs = np.stack([_uff_point_xyz(p) if isinstance(p, dict)
                         else np.array([0, 0, 1.0]) for p in pts])
        nrm = np.linalg.norm(dirs, axis=1, keepdims=True)
        nrm[nrm == 0] = 1.0
        dirs = dirs / nrm
        seq = Sequence(type="PW", focus=dirs.T, c0=c0)
        return seq, delay
    xyz = np.stack([_uff_point_xyz(p) for p in pts])  # (M, 3)
    if elem_pos is not None and xyz.shape[0] == elem_pos.shape[1] and \
            np.allclose(xyz.T, elem_pos, atol=1e-6):
        seq = Sequence(type="FSA", numpulse=xyz.shape[0], c0=c0)
        t0 = delay - np.linalg.norm(elem_pos, axis=0) / c0
        return seq, t0
    seq = Sequence(type="VS", focus=xyz.T, c0=c0)
    t0 = delay - np.linalg.norm(xyz, axis=1) / c0
    return seq, t0


def load_uff(path):
    """Read a UFF HDF5 file — both the :func:`save_uff` dialect and files
    written by MATLAB USTB (``uff.write``): group/dataset 'class'
    attributes as char-code arrays, char datasets as uint16 code points,
    complex values as real/imag subgroup pairs, column-major (reversed-
    axis) arrays, uff.wave sequence children with uff.point sources, and
    probe geometry from uff.linear_array/curvilinear_array/matrix_array
    properties. Returns a dict with any of 'chd', 'xdc', 'seq', 'scan'
    (mapping per the reference's ``ChannelData.UFF``/``Sequence.UFF``/
    ``Transducer.UFF``, ``src/ChannelData.m:180-240``,
    ``src/Sequence.m:540-612``, ``src/Transducer.m:558-574``)."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        matlab = "qups-tpu" not in _uff_attr(f, "version", "")
        # find the first channel_data-class group (or take the root groups)
        groups = [g for g in f.values() if isinstance(g, h5py.Group)]
        g = None
        for cand in groups:
            if _uff_class(cand) == "uff.channel_data":
                g = cand
                break
        if g is None and groups:
            g = groups[0]
        if g is None:
            return out
        c0 = float(np.squeeze(_uff_read_value(g["sound_speed"]))) \
            if "sound_speed" in g else 1540.0
        fc_pulse = None
        if "pulse" in g and isinstance(g["pulse"], h5py.Group) and \
                "center_frequency" in g["pulse"]:
            fc_pulse = float(np.squeeze(
                _uff_read_value(g["pulse"]["center_frequency"])))
        if "probe" in g:
            pg = g["probe"]
            cls = _uff_class(pg) or "uff.probe"
            geom = None
            if "geometry" in pg:
                geom = np.asarray(_uff_read_value(pg["geometry"]))
                if geom.ndim == 2 and geom.shape[0] == 7 and \
                        geom.shape[1] != 7:
                    geom = geom.T  # MATLAB column-major: stored (7, N)
            if "fc" in pg:
                fc = float(np.squeeze(_uff_read_value(pg["fc"])))
            else:
                fc = fc_pulse or 5e6
            N_el = int(np.squeeze(_uff_read_value(pg["N"]))) if "N" in pg \
                else (geom.shape[0] if geom is not None else 0)
            kw = dict(fc=fc, numel=N_el)
            if geom is not None and geom.shape[1] >= 7:
                kw["width"] = float(geom[0, 5])
                kw["height"] = float(geom[0, 6])
            elif "element_width" in pg:
                kw["width"] = float(np.squeeze(
                    _uff_read_value(pg["element_width"])))
                if "element_height" in pg:
                    kw["height"] = float(np.squeeze(
                        _uff_read_value(pg["element_height"])))
            if "bw" in pg:
                bwv = np.asarray(_uff_read_value(pg["bw"])).reshape(-1)
                kw["bw"] = (float(bwv[0]), float(bwv[-1]))
            if cls == "uff.linear_array" and "pitch" in pg:
                out["xdc"] = TransducerArray(
                    pitch=float(np.squeeze(_uff_read_value(pg["pitch"]))), **kw)
            elif cls == "uff.curvilinear_array" and "radius" in pg:
                rad = float(np.squeeze(_uff_read_value(pg["radius"])))
                if "angular_pitch" in pg:
                    apitch = float(np.squeeze(
                        _uff_read_value(pg["angular_pitch"])))
                else:  # USTB stores the linear pitch along the arc
                    apitch = np.degrees(float(np.squeeze(
                        _uff_read_value(pg["pitch"]))) / rad)
                out["xdc"] = TransducerConvex(radius=rad,
                                              angular_pitch=apitch, **kw)
            elif cls == "uff.matrix_array" and ("pitch2" in pg
                                                or "pitch_x" in pg):
                if "pitch2" in pg:
                    p2 = np.asarray(_uff_read_value(pg["pitch2"])).reshape(-1)
                    nd = np.asarray(_uff_read_value(pg["numd"])).reshape(-1)
                else:  # USTB field names
                    p2 = [float(np.squeeze(_uff_read_value(pg["pitch_x"]))),
                          float(np.squeeze(_uff_read_value(pg["pitch_y"])))]
                    nd = [int(np.squeeze(_uff_read_value(pg["N_x"]))),
                          int(np.squeeze(_uff_read_value(pg["N_y"])))]
                kw.pop("numel", None)
                out["xdc"] = TransducerMatrix(
                    pitch2=(float(p2[0]), float(p2[1])),
                    numd=(int(nd[0]), int(nd[1])), **kw)
            elif geom is not None:
                out["xdc"] = TransducerGeneric(
                    pos=tuple(map(tuple, geom[:, :3].T)),
                    az=tuple(np.degrees(geom[:, 3])),
                    el=tuple(np.degrees(geom[:, 4])), **kw)
        t0_seq = None
        if "sequence" in g and "qups_type" in g["sequence"]:
            sg = g["sequence"]
            styp = _uff_read_value(sg["qups_type"])
            if styp == "FSA":
                npu = int(np.squeeze(_uff_read_value(sg["numpulse"]))) \
                    if "numpulse" in sg else None
                out["seq"] = Sequence(type="FSA", numpulse=npu, c0=c0)
            else:
                foc = np.asarray(_uff_read_value(sg["source_xyz"])).T
                out["seq"] = Sequence(type=styp, focus=foc, c0=c0)
        elif "sequence" in g and isinstance(g["sequence"], h5py.Group):
            # USTB: children are uff.wave groups (object-array layout)
            sg = g["sequence"]
            wave_nodes = [v for k, v in sorted(sg.items())
                          if isinstance(v, h5py.Group)]
            if not wave_nodes and _uff_class(sg) == "uff.wave":
                wave_nodes = [sg]
            waves = [_uff_read_value(w) for w in wave_nodes]
            if waves:
                ep = out["xdc"].positions() if "xdc" in out else None
                out["seq"], t0_seq = _seq_from_ustb_waves(waves, c0, ep)
        if "data" in g:
            data = np.asarray(_uff_read_value(g["data"]))
            if matlab and data.ndim >= 2:
                # h5 row-major view of a MATLAB column-major (T,N,M,F)
                data = np.transpose(data)
            fs = float(np.squeeze(_uff_read_value(g["sampling_frequency"]))) \
                if "sampling_frequency" in g else 1.0
            if "t0" in g:
                t0 = _uff_read_value(g["t0"])
            elif t0_seq is not None:
                # the reference takes t0 from the per-wave delays
                # (``ChannelData.UFF``, ``src/ChannelData.m:219-230``);
                # fall back to initial_time when the delays are all zero
                # (the common USTB plane-wave-dataset convention)
                it0 = float(np.squeeze(_uff_read_value(g["initial_time"]))) \
                    if "initial_time" in g else 0.0
                t0 = np.asarray(t0_seq, np.float64)
                if np.all(t0 == 0.0) and it0 != 0.0:
                    t0 = it0
                elif np.allclose(t0, t0.reshape(-1)[0]):
                    t0 = float(t0.reshape(-1)[0])
                else:
                    t0 = t0.reshape(1, 1, -1)
            elif "initial_time" in g:
                t0 = float(np.squeeze(_uff_read_value(g["initial_time"])))
            else:
                t0 = 0.0
            out["chd"] = ChannelData(data=np.asarray(data), fs=fs,
                                     t0=np.asarray(t0, np.float64))
        if "modulation_frequency" in g:
            # demodulated (IQ) data: USTB stores the carrier here; feed it
            # to DAS(fmod=...) on import (``src/ChannelData.m:93-114``)
            fmod = float(np.squeeze(
                _uff_read_value(g["modulation_frequency"])))
            if fmod:
                out["fmod"] = fmod
        if "scan" in g:
            sg = g["scan"]
            cls = _uff_class(sg)
            if cls == "uff.linear_scan":
                out["scan"] = ScanCartesian(
                    x=np.asarray(_uff_read_value(sg["x_axis"])).reshape(-1),
                    y=np.asarray(_uff_read_value(sg["y_axis"])).reshape(-1)
                    if "y_axis" in sg else [0.0],
                    z=np.asarray(_uff_read_value(sg["z_axis"])).reshape(-1))
            elif cls == "uff.sector_scan":
                org = np.zeros(3)
                if "origin" in sg:
                    ov = _uff_read_value(sg["origin"])
                    if isinstance(ov, dict):  # USTB uff.point origin
                        org = _uff_point_xyz(ov)
                    else:
                        org = np.asarray(ov).reshape(-1)[:3]
                out["scan"] = ScanPolar(
                    origin=tuple(org),
                    r=np.asarray(_uff_read_value(sg["depth_axis"])).reshape(-1),
                    a=np.degrees(np.asarray(
                        _uff_read_value(sg["azimuth_axis"])).reshape(-1)))
            elif cls == "uff.scan":
                qt = _uff_read_value(sg["qups_type"]) \
                    if "qups_type" in sg else ""
                if qt == "spherical":
                    org = np.asarray(
                        _uff_read_value(sg["origin"])).reshape(-1)[:3] \
                        if "origin" in sg else np.zeros(3)
                    out["scan"] = ScanSpherical(
                        origin=tuple(org),
                        r=np.asarray(_uff_read_value(
                            sg["depth_axis"])).reshape(-1),
                        a=np.degrees(np.asarray(_uff_read_value(
                            sg["azimuth_axis"])).reshape(-1)),
                        e=np.degrees(np.asarray(_uff_read_value(
                            sg["elevation_axis"])).reshape(-1)))
                else:  # generic / genuine-USTB base scan: xyz points
                    P = np.stack([np.asarray(
                        _uff_read_value(sg[k])).reshape(-1)
                        for k in ("x", "y", "z")])
                    shp = tuple(np.asarray(_uff_read_value(
                        sg["shape"])).reshape(-1).astype(int)) \
                        if "shape" in sg else (P.shape[1], 1, 1)
                    out["scan"] = ScanGeneric(pos=P.reshape((3,) + shp))
    return out


# --------------------------------------------------------------------------
# MATLAB .mat round trip of the port's objects
# --------------------------------------------------------------------------
def save_mat(path, **objs):
    """Save the port's objects to a MATLAB v5 .mat file (obj2dict encoding)."""
    from scipy.io import savemat
    from .io import obj2dict
    enc = {}
    for k, v in objs.items():
        d = obj2dict(v)
        enc[k] = _mat_sanitize(d)
    savemat(path, enc, long_field_names=True)


def _mat_sanitize(d):
    if isinstance(d, dict):
        return {k: _mat_sanitize(v) for k, v in d.items() if v is not None}
    if isinstance(d, (list, tuple)):
        try:
            return np.asarray(d)
        except Exception:
            return [_mat_sanitize(v) for v in d]
    return d


def load_mat(path):
    """Load a .mat written by :func:`save_mat` (of either package) back into
    the port's objects."""
    from scipy.io import loadmat
    from .io import dict2obj
    w = loadmat(path, squeeze_me=True, simplify_cells=True)
    out = {}
    for k, v in w.items():
        if k.startswith("__"):
            continue
        out[k] = dict2obj(_mat_restore(v))
    return out


def _mat_restore(v):
    if isinstance(v, dict):
        return {k: _mat_restore(x) for k, x in v.items()}
    return v
