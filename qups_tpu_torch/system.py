"""UltrasoundSystem: the sim→image, plane-wave imaging and simulator slices
of the port.

Port of the parts of :class:`qups_tpu.system.UltrasoundSystem` that the
main paths run: build a system from a transducer, a sequence and a scan;
simulate channel data with :meth:`UltrasoundSystem.greens`,
:meth:`UltrasoundSystem.simus`, :meth:`UltrasoundSystem.calc_scat_all` and
:meth:`UltrasoundSystem.calc_scat_multi`, and synthesize the sequence's
transmits with :meth:`UltrasoundSystem.focusTx`; map the transmit pressure
with :meth:`UltrasoundSystem.calc_hp`; beamform with
:meth:`UltrasoundSystem.DAS`, :meth:`UltrasoundSystem.bfDAS`,
:meth:`UltrasoundSystem.bfDASLUT` and :meth:`UltrasoundSystem.bfAdjoint`.
Host geometry stays float64 numpy and moves to the data's device as
float32.

Scope (ROADMAP.md, "Scope decisions"):

* ``greens(impl='auto')`` resolves as in the JAX package: the
  frequency-domain engine (``'freq'``, kernel K3, ``ops/greens_freq_cuda.py``)
  on a CUDA device, the splat on the CPU. ``impl='pallas'`` is the
  time-domain splat of kernel K5 (``ops/greens_cuda.py``);
  ``precision='bf16'`` rounds K3's operands (K3(b)). ``simus`` runs K3 with
  the element directivity (K3(c)).
* ``focusTx`` synthesizes any sequence: 'freq' (the per-bin transmit GEMM,
  'auto' on a CUDA device) or a time-domain sampler ('cubic', 'auto' on the
  CPU).
* The beamformers (``DAS``, ``bfDAS``, ``bfDASLUT``, ``bfAdjoint``) and
  ``focusTx``, like the simulators, run on the CUDA device unless given
  ``device=``, and move the traces there. On a CUDA tensor, ``DAS`` runs
  kernel K1 (``ops/das_cuda.py``) and, with a per-pixel sound speed,
  kernel K2 through ``bfDASLUT``; ``bfDAS`` and ``bfDASLUT`` run K2; both
  take frame dims and IQ remodulation (``fmod``), keep modes,
  apodization and the reduced-precision traces of ``precision=`` ('auto'
  is float32 on every device); ``coherence_image`` reduces
  ``DAS(keep_rx=True)`` over the aperture; ``bfAdjoint`` runs
  kernel K4 (``ops/fdbf_cuda.py``). An option a kernel does not carry
  raises ``NotImplementedError`` naming its sub-slice. Nothing drops to
  the plain path on its own: ``kernel='plain'`` is an explicit choice.
  With ``device="cpu"`` each runs its plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .core.channel_data import ChannelData
from .core.scan import Scan, ScanCartesian, ScanPolar
from .core.scat import Scatterers
from .core.seq import Sequence
from .core.xdc import Transducer, TransducerArray, TransducerConvex
from .ops.das import das, das_lut, delay_tables, rx_distance, tx_distance
from .ops.das_cuda import Fused, das_lut_sum, das_sum, dense_apod
from .ops.coherence import cohfac, slsc
from .ops.conv import convd
from .ops.fdbf import bf_adjoint, focus_tx_freq, geom_delays, select_fbins
from .ops.fdbf_cuda import bf_adjoint_cuda
from .ops.greens import greens_dense, greens_splat
from .ops.greens_cuda import greens_tiled
from .ops.greens_freq import greens_freq
from .ops.interp import METHODS, fft_upsample
from .ops.simus import simus_fsa
from .utils.backend import as_f32, default_device
from .utils.maths import box_rbounds

PRECISIONS = ("auto", "f32", "bf16pair", "i8x4", "bf16")
KERNELS = ("auto", "cuda", "plain")


def _kernel_precision(precision: str) -> str:
    """The trace precision K1 and K2 take for a beamformer's ``precision``:
    'auto' is 'f32' on every device."""
    return "f32" if precision == "auto" else precision


@dataclass(frozen=True)
class UltrasoundSystem:
    tx: Transducer = None
    rx: Transducer = None
    seq: Sequence = None
    scan: Scan = None
    fs: float = None  # simulation sampling frequency [Hz]

    def __post_init__(self):
        if self.rx is None and self.tx is None:
            object.__setattr__(self, "rx", TransducerArray.P4_2v())
        if self.tx is None:
            object.__setattr__(self, "tx", self.rx)
        if self.rx is None:
            object.__setattr__(self, "rx", self.tx)
        if self.fs is None:
            object.__setattr__(self, "fs", float(2 * max(
                2 * self.tx.fc, self.tx.bw[1], 2 * self.rx.fc, self.rx.bw[1])))
        if self.seq is None:
            object.__setattr__(self, "seq", Sequence(
                type="FSA", numpulse=self.tx.numel))
        if self.scan is None:
            lam4 = self.lmbda / 4
            if isinstance(self.rx, TransducerConvex):
                c = self.rx.center
                scan = ScanPolar(origin=c,
                                 r=np.arange(0, 40e-3 + np.linalg.norm(c), lam4),
                                 a=np.arange(-45.0, 45.5, 1.0))
            else:
                scan = ScanCartesian().with_resolution(dx=lam4, dz=lam4)
            object.__setattr__(self, "scan", scan)

    # ------------------------------------------------------------ properties
    @property
    def xdc(self) -> Transducer:
        assert self.tx is self.rx or self.tx == self.rx, "tx and rx differ"
        return self.rx

    @property
    def fc(self) -> float:
        return self.rx.fc

    @property
    def lmbda(self) -> float:
        """Wavelength at the center frequency."""
        return self.seq.c0 / self.fc if self.seq is not None else 1540.0 / self.fc

    def replace(self, **changes) -> "UltrasoundSystem":
        return dataclasses.replace(self, **changes)

    def scale(self, dist: float = 1.0, time: float = 1.0) -> "UltrasoundSystem":
        """Consistent unit rescale of all linked objects, e.g.
        ``scale(dist=1e3, time=1e6)`` for mm and us units."""
        same = self.tx is self.rx
        tx = self.tx.scale(dist=dist, time=time)
        return dataclasses.replace(
            self, tx=tx, rx=tx if same else self.rx.scale(dist=dist, time=time),
            seq=self.seq.scale(dist=dist, time=time),
            scan=self.scan.scale(dist=dist), fs=self.fs / time)

    # ------------------------------------------------------- geometry helpers
    def _tx_geometry(self):
        """Per-sequence-type (pv, nv, tx_model): virtual sources (M, 3),
        normals (M, 3) and the transmit model."""
        st = self.seq.type
        if st == "FSA":
            pv = self.tx.positions().T  # (M, 3)
            _, _, nf, _, _ = self.tx.orientations()
            return pv, nf.T, "diverging"
        if st == "PW":
            f = self.seq.focus_array  # unit directions
            return np.zeros((f.shape[1], 3)), f.T, "plane"
        # FC / DV / VS: virtual sources at the foci
        f = self.seq.focus_array
        nf = f - self.tx.origin[:, None]
        nf = nf / np.linalg.norm(nf, axis=0, keepdims=True)
        return f.T, nf.T, "diverging" if st == "DV" else "virtual"

    def _pixels(self) -> np.ndarray:
        return self.scan.positions().reshape(3, -1).T.astype(np.float32)  # (I, 3)

    # ------------------------------------------------------------- simulators
    def greens(self, scat: Scatterers,
               element_subdivisions: Tuple[int, int] = (1, 1),
               R0: Optional[float] = None, method: str = "auto",
               impl: str = "auto", fsk: Optional[float] = None,
               block: int = 32, rtol: float = 1e-6, precision: str = "highest",
               kernel: str = "auto", device=None) -> ChannelData:
        """Simulate echoes from point scatterers with a shifted Green's
        function, then apply the transmit sequence with :meth:`focusTx`.

        ``impl``: 'auto' is the frequency-domain engine on a CUDA device and
        the splat on the CPU, as the JAX package picks 'freq' off the CPU;
        'freq' is the per-bin GEMM engine (kernel K3; ``rtol`` trims the
        synthesis band to kernel-spectrum bins above ``rtol * max``);
        'pallas' the range-sorted time-domain splat (kernel K5; its basis is
        ``method`` when 'linear' or 'cubic', else cubic); 'splat' the
        scatter-add + FFT path; 'dense' the O(T S N M) oracle.

        ``precision`` (freq): 'highest' and 'default' run the GEMM in
        float32; 'bf16' rounds its operands to bfloat16 and sums in float32
        (sub-slice K3(b)). The other engines ignore it, as in the JAX
        package.

        ``kernel`` (freq, pallas): 'auto' runs the engine's kernel (K3, K5)
        on a CUDA device and its plain version on the CPU; 'cuda' requires
        the kernel; 'plain' runs the plain version on any device.

        ``device``: where the simulated traces live (default: the CUDA
        device; ``device="cpu"`` runs the plain versions on the CPU).

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.greens(scat, device="cpu")
            # echo arrives at the round-trip time 2 * 20mm / c0 ~ 26 us
            t = chd.time.reshape(-1).numpy()
            t_pk = t[int(chd.data[:, 0, 0].abs().argmax())]
            assert abs(t_pk - 2 * 20e-3 / 1540.0) < 1e-6
        """
        device = default_device(device)
        on_cpu = device.type == "cpu"
        if impl == "auto":
            impl = "splat" if on_cpu else "freq"
        if impl not in ("freq", "pallas", "splat", "dense"):
            raise ValueError(f"unknown impl {impl!r}")
        # the deposit basis stays cubic (the reference default); 'freq'
        # names the transmit synthesis of focusTx, as in the JAX package
        if method == "auto":
            fmethod, method = ("cubic" if on_cpu else "freq"), "cubic"
        elif method == "freq":
            fmethod, method = "freq", "cubic"
        else:
            fmethod = method
        ps, kern, pn, pv, kw = self._greens_problem(
            scat, element_subdivisions, R0, fsk)
        fs, s0 = kw["fs"], kw["s0"]
        if impl == "freq":
            x = greens_freq(kern, ps, scat.amp, pn, pv, rtol=rtol,
                            precision=precision, alpha0=float(scat.alpha0),
                            kernel=kernel, device=device, **kw)
            return self.focusTx(ChannelData(data=x, fs=fs, t0=s0), self.seq,
                                method=fmethod, device=device)
        if float(scat.alpha0):
            warnings.warn(
                "greens: Scatterers.alpha0 attenuation requires the "
                f"frequency-domain engine; impl={impl!r} ignores it",
                stacklevel=2)
        if impl == "pallas":
            kw.update(method=method if method in ("linear", "cubic") else "cubic",
                      kernel=kernel, device=device)
            amp = np.asarray(scat.amp)
            if not (np.iscomplexobj(kern) or np.iscomplexobj(amp)):
                x = greens_tiled(kern, ps, amp, pn, pv, **kw)
                return self.focusTx(ChannelData(data=x, fs=fs, t0=s0), self.seq,
                                    method=fmethod, device=device)
            # complex kernel or amplitudes: a splat pass per real amplitude
            # part, joined as x1 + i x2; the JAX package then focuses with t0
            # = s0 + dt0 taken in float64 (its _ri_focus), so the port does
            cz = np.asarray(kern, np.complex64)
            az = amp.astype(np.complex64)
            x = greens_tiled(cz, ps, np.real(az), pn, pv, **kw)
            if np.any(np.imag(az)):
                x = x + 1j * greens_tiled(cz, ps, np.imag(az), pn, pv, **kw)
            plan = self._focus_plan(fs, 3, self.seq)
            if plan is None:
                return ChannelData(data=x, fs=fs, t0=s0)
            t2, w, dt0, pad = plan
            chd = ChannelData(data=x, fs=fs, t0=s0 + dt0).zeropad(0, pad)
            return self._focus_apply(chd, t2, w, fmethod)
        kw.update(method=method, device=device)
        if impl == "splat":
            x = greens_splat(kern, ps, scat.amp, pn, pv, block=block, **kw)
        else:
            x = greens_dense(kern, ps, scat.amp, pn, pv, **kw)
        chd = ChannelData(data=x, fs=fs, t0=s0)
        return self.focusTx(chd, self.seq, method=fmethod, device=device)

    def _greens_problem(self, scat: Scatterers,
                        element_subdivisions: Tuple[int, int] = (1, 1),
                        R0: Optional[float] = None, fsk: Optional[float] = None):
        """Host-side set-up of :meth:`greens`: scatterer positions (S, 3),
        the convolved kernel, rx/tx sub-element positions (N|M, E, 3) and
        the simulators' keyword arguments (T, s0, t0k, fs, cinv, R0, fsr)."""
        fs = float(self.fs)
        fsk = float(fsk or fs)
        c0 = float(scat.c0)
        R0 = float(self.lmbda if R0 is None else R0)

        # sub-element positions (N, E, 3)
        if element_subdivisions == (1, 1):
            pn = self.rx.positions().T[:, None, :]
            pv = self.tx.positions().T[:, None, :]
        else:
            pn = np.moveaxis(self.rx.bary_centers(element_subdivisions), 0, -1)
            pv = np.moveaxis(self.tx.bary_centers(element_subdivisions), 0, -1)

        # convolved kernel waveform: rx impulse (x) tx impulse (x) seq pulse
        wv = self.rx.impulse.conv(self.tx.impulse.conv(self.seq.pulse, fsk), fsk)
        wv = dataclasses.replace(wv, fs=fsk)
        kern = np.asarray(wv.samples)

        # time bounds from conservative box-to-box geometry: O(S + N) host work
        ps = scat.pos  # (3, S)
        rx_lo, rx_hi = box_rbounds(ps.T, pn)
        tx_lo, tx_hi = box_rbounds(ps.T, pv)
        tmin = (rx_lo + tx_lo) / c0 + wv.t0 - wv.duration
        tmax = (rx_hi + tx_hi) / c0 + wv.tend
        n0 = math.floor(tmin * fs)
        T = math.ceil(tmax * fs) - n0 + 1
        s0 = n0 / fs
        kw = dict(T=T, s0=s0, t0k=float(wv.t0), fs=fs, cinv=1.0 / c0, R0=R0,
                  fsr=fsk / fs)
        return ps.T, kern, pn, pv, kw

    # ---------------------------------------------------- transmit synthesis
    def _focus_plan(self, fs: float, ndim: int, seq: Sequence,
                    buffer: int = 0):
        """Host-side planning for :meth:`focusTx`: ``None`` for the true-FSA
        identity, else ``(t2, w, dt0, pad)``: the shaped delay and
        apodization tensors, the t0 shift and the zero-padding."""
        tau = -seq.delays(self.tx)          # (M, M')
        apd = seq.apodization(self.tx)      # (M, M')
        if seq.type == "FSA" and not np.count_nonzero(tau) \
                and np.array_equal(apd, np.eye(self.tx.numel)):
            return None  # true FSA: identity
        mask = apd.astype(bool) | np.zeros_like(tau, bool)
        nmin = math.floor(np.min(tau[mask]) * fs)
        nmax = math.ceil(np.max(tau[mask]) * fs)
        tau = tau - nmin / fs
        nd = max(ndim, 3)
        M, Mp = tau.shape
        t2 = -tau.reshape((1, 1, M) + (1,) * (nd - 3) + (Mp,))
        w = apd.reshape((1, 1, M) + (1,) * (nd - 3) + (Mp,))
        return t2, w, nmin / fs, (nmax - nmin) + buffer

    def focusTx(self, chd: ChannelData, seq: Optional[Sequence] = None,
                method: str = "auto", buffer: int = 0, device=None) -> ChannelData:
        """Synthesize transmits from FSA data: delay-and-sum across
        transmits. ``method``: 'freq', the per-bin transmit GEMM
        ``Y_k = X_k H_k`` (band-limited interpolation), or a time-domain
        sampler 'nearest' | 'linear' | 'cubic' | 'lanczos3' (through
        ``ChannelData.sample2sep``); 'auto' is 'freq' on a CUDA device and
        'cubic' on the CPU, as the JAX package picks 'freq' off the CPU.
        The true-FSA sequence is the identity. ``device``: where to
        synthesize (default: the CUDA device; the traces move there).

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=[0.0], z=[20e-3]), fs=12e6)
            rng = np.random.default_rng(0)
            chd = q.ChannelData(
                data=rng.standard_normal((64, 4, 4)).astype(np.float32),
                fs=12e6, t0=0.0)
            pw = q.SequenceRadial(type="PW", angles=[0.0], c0=1540.0)
            out = us.focusTx(chd, pw, device="cpu")   # 4 FSA transmits -> 1 PW
            assert out.data.shape[2] == 1
        """
        seq = seq or self.seq
        device = default_device(device)
        chd = chd.replace(data=chd.data.to(device))
        if method == "auto":
            method = "cubic" if device.type == "cpu" else "freq"
        plan = self._focus_plan(chd.fs, chd.data.ndim, seq, buffer)
        if plan is None:
            return chd
        t2, w, dt0, pad = plan
        return self._focus_apply(self._focus_t0(chd, dt0, pad), t2, w, method)

    @staticmethod
    def _focus_t0(chd: ChannelData, dt0: float, pad: int) -> ChannelData:
        """Shift t0 by ``dt0`` and zero-pad ``pad`` samples at the end: the
        float32 t0, shifted in float32, as the JAX package's device t0."""
        chd = chd.replace(t0=np.asarray(chd.t0, np.float32) + np.float32(dt0))
        return chd.zeropad(0, pad)

    @staticmethod
    def _focus_apply(chd: ChannelData, t2, w, method: str) -> ChannelData:
        """The synthesis of :meth:`focusTx` on shifted, padded traces, for
        the transmit columns of ``t2``, ``w`` (1, 1, M, ..., M')."""
        if method == "freq":
            M, Mp = t2.shape[2], t2.shape[-1]
            z = focus_tx_freq(chd.data, t2.reshape(M, Mp), w.reshape(M, Mp),
                              fs=float(chd.fs))
            return chd.replace(data=z)
        z = chd.sample2sep(chd.time, t2, method=method, w=w, sdim=2)
        return chd.replace(data=torch.movedim(z[:, :, 0], -1, 2))  # (T', N, M', F...)

    # ------------------------------------------------------ other simulators
    def simus(self, scat: Scatterers, baffle: str = "soft",
              fthresh_db: float = -60.0,
              element_subdivisions: Tuple[int, int] = (1, 1),
              kernel: str = "auto", device=None) -> ChannelData:
        """Frequency-domain point-scatterer simulation with far-field
        element directivity, the native analog of the MUST/SIMUS interop:
        FSA synthesis by per-bin complex GEMMs with the rectangular-element
        sinc directivity (kernel K3 with its directivity, K3(c); see
        :mod:`qups_tpu_torch.ops.simus`), then :meth:`focusTx`. The bins are
        those of the pulse spectrum within ``fthresh_db`` of its peak.
        ``baffle``: 'soft' (obliquity ``cos th``) or 'hard'.
        ``Scatterers.alpha0`` [dB/cm/MHz] applies frequency-linear absorption
        over both legs. ``element_subdivisions`` is accepted and ignored, as
        in the JAX package: the directivity models the whole element.

        ``kernel``: 'auto' runs K3 on a CUDA device and its plain version on
        the CPU; 'cuda' requires K3; 'plain' runs the plain version.
        ``device``: where the traces live (default: the CUDA device).

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.simus(scat, device="cpu")
            assert chd.data.shape[1:3] == (4, 4)
            assert bool(chd.data.isfinite().all())
        """
        device = default_device(device)
        fs = float(self.fs)
        c0 = float(scat.c0)
        wv = self.rx.impulse.conv(self.tx.impulse.conv(self.seq.pulse, fs), fs)
        wv = dataclasses.replace(wv, fs=fs)
        kern = np.asarray(wv.samples)
        if np.iscomplexobj(kern):
            kern = np.real(kern)
        pn = self.rx.positions().T
        pv = self.tx.positions().T
        ps = scat.pos

        # conservative box-to-box distance bounds: O(S + N) host work
        rx_lo, rx_hi = box_rbounds(ps.T, pn)
        tx_lo, tx_hi = box_rbounds(ps.T, pv)
        tmin = (rx_lo + tx_lo) / c0 + wv.t0 - wv.duration
        tmax = (rx_hi + tx_hi) / c0 + wv.tend
        n0 = math.floor(tmin * fs)
        T = int(math.ceil(tmax * fs)) - n0 + 1
        s0 = n0 / fs

        # the bins where the pulse spectrum is above the threshold
        KERN = np.fft.rfft(kern, n=T)
        lev = 20 * np.log10(np.abs(KERN) + 1e-30)
        sel = np.where(lev >= lev.max() + fthresh_db)[0]
        sel = sel[sel > 0]
        f = sel * fs / T
        spec = KERN[sel] * np.exp(-2j * np.pi * f * (wv.t0 - s0))

        az_rx = self.rx.orientations()[0]
        az_tx = self.tx.orientations()[0]
        x = simus_fsa(ps.T, np.asarray(scat.amp, np.float32), pn,
                      np.radians(np.broadcast_to(az_rx, (self.rx.numel,))), pv,
                      np.radians(np.broadcast_to(az_tx, (self.tx.numel,))),
                      np.asarray([self.tx.width, self.rx.width], np.float32),
                      spec.astype(np.complex64), sel.astype(np.int32), T=T,
                      fs=fs, c0=c0, baffle=baffle, alpha0=float(scat.alpha0),
                      kernel=kernel, device=device)
        return self.focusTx(ChannelData(data=x, fs=fs, t0=s0), self.seq, device=device)

    def calc_scat_all(self, scat: Scatterers,
                      element_subdivisions: Tuple[int, int] = (1, 1),
                      **kw) -> ChannelData:
        """FieldII ``calc_scat_all`` analog: one linear-scattering simulation
        of all tx-element x rx-element pairs (FSA), then :meth:`focusTx`
        applies the sequence. By superposition this is exactly
        :meth:`greens`, whose keyword arguments pass through (``impl``,
        ``method``, ``precision``, ``kernel``, ``device``, ...)."""
        return self.greens(scat, element_subdivisions, **kw)

    def calc_scat_multi(self, scat: Scatterers,
                        element_subdivisions: Tuple[int, int] = (1, 1),
                        bsize: Optional[int] = None, method: str = "auto",
                        **kw) -> ChannelData:
        """FieldII ``calc_scat_multi`` analog: the per-transmit simulation
        with the sequence's delays and apodization. In a linear medium the
        per-transmit response is the FSA response synthesized per transmit,
        so this runs one FSA :meth:`greens` (keyword arguments pass through)
        and folds the sequence ``bsize`` transmits at a time, or all at once
        when ``None``. ``method`` goes to :meth:`greens` as given; for the
        synthesis 'auto' is 'freq' on a CUDA ``device`` (the default) and
        'cubic' on the CPU, as :meth:`greens` resolves it. All blocks share one focus plan
        (t0 shift and zero-pad), so blocked and unblocked results agree.

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            seq = q.SequenceRadial(type="PW", angles=[-5.0, 5.0], c0=1540.0)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=seq,
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            a = us.calc_scat_multi(scat, device="cpu")           # all at once
            b = us.calc_scat_multi(scat, bsize=1, device="cpu")  # blocked
            assert float((a.data - b.data).abs().max()) < 1e-5
        """
        kw["method"] = method
        if method == "auto":
            on_cpu = default_device(kw.get("device")).type == "cpu"
            method = "cubic" if on_cpu else "freq"
        if self.seq.type == "FSA":
            return self.greens(scat, element_subdivisions, **kw)
        fsa = Sequence(type="FSA", c0=self.seq.c0, pulse=self.seq.pulse,
                       numpulse=self.tx.numel)
        chd = self.replace(seq=fsa).greens(scat, element_subdivisions, **kw)
        plan = self._focus_plan(chd.fs, chd.data.ndim, self.seq)
        if plan is None:  # identity sequence
            return chd
        t2, w, dt0, pad = plan
        Mp = t2.shape[-1]
        b = int(bsize) if bsize else Mp
        if b >= Mp:
            return self.focusTx(chd, self.seq, method=method, device=chd.data.device)
        chd = self._focus_t0(chd, dt0, pad)
        outs = [self._focus_apply(chd, t2[..., i:i + b], w[..., i:i + b], method).data
                for i in range(0, Mp, b)]
        return chd.replace(data=torch.cat(outs, dim=2))

    def calc_hp(self, scan: Optional[Scan] = None, seq: Optional[Sequence] = None,
                out: str = "max", R0: Optional[float] = None, device=None):
        """Transmit pressure-field maps, the native analog of FieldII's
        ``calc_hp``: the one-way impulse pressure at every scan pixel from
        each transmit,

            p(t, pix; m) = sum_e apd(e, m) wv(t - fire_e(m) - r_e(pix)/c) / r_e

        with ``wv = tx.impulse (x) seq.pulse`` and the 1/r spreading clamped
        at ``R0`` (default: a wavelength): per transmit, a linear splat of
        every (pixel, element) delay into a (time, pixel) grid and one
        convolution with ``wv``, as the JAX package computes it.

        Returns, on ``device`` (default: the CUDA device), ``out='max'``: the
        max-pressure map ``(I1, I2, I3, M)`` float32 tensor; ``out='field'``:
        ``(p (T, I, M), t0)``, the full time series and its start time.

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
            pf = np.array([[0.0], [0.0], [20e-3]])
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FC", focus=pf, c0=1540.0),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 9),
                                     z=np.linspace(16e-3, 24e-3, 9)),
                fs=12e6)
            p = us.calc_hp(device="cpu")      # (I1, I2, I3, M) max pressure
            assert tuple(p.shape) == (9, 9, 1, 1)
            # the focused transmit concentrates pressure on axis (x = 0)
            P = us.scan.positions().reshape(3, -1)
            assert abs(P[0, int(p[..., 0].reshape(-1).argmax())]) < 1e-3
        """
        if out not in ("max", "field"):
            raise ValueError(f"unknown out {out!r}; expected 'max' or 'field'")
        device = default_device(device)
        scan = scan or self.scan
        seq = seq or self.seq
        fs = float(self.fs)
        c0 = float(seq.c0)
        R0 = float(self.lmbda if R0 is None else R0)
        wv = self.tx.impulse.conv(seq.pulse, fs)
        wv = dataclasses.replace(wv, fs=fs)
        kern = np.asarray(wv.samples)
        if np.iscomplexobj(kern):
            kern = np.real(kern)
        K = kern.shape[0]

        P = scan.positions().reshape(3, -1)  # (3, I)
        pe = self.tx.positions()             # (3, E)
        fire = -seq.delays(self.tx)          # (E, M)
        apd = seq.apodization(self.tx)       # (E, M)
        M = seq.num_pulse

        # time bounds from box-to-box interval arithmetic, O(I + E)
        rmax = float(np.linalg.norm(np.maximum(
            np.abs(P.max(1) - pe.min(1)), np.abs(pe.max(1) - P.min(1)))))
        gap = np.maximum(np.maximum(P.min(1) - pe.max(1), pe.min(1) - P.max(1)), 0.0)
        rmin = float(np.linalg.norm(gap))
        tmin = rmin / c0 + fire.min() + wv.t0
        tmax = rmax / c0 + fire.max() + wv.tend
        n0 = math.floor(tmin * fs)
        T = math.ceil(tmax * fs) - n0 + 1
        s0 = n0 / fs
        G = T + 2 * K
        I = P.shape[1]

        rj = geom_delays(P.T, pe.T, np.float32(1.0), device)  # (I, E) distances
        w_r = 1.0 / torch.clamp(rj, min=float(np.float32(R0)))
        col = torch.arange(I, device=device)[:, None].expand(rj.shape)
        kt = torch.as_tensor(kern.astype(np.float32), device=device).reshape(-1, 1)
        ps = []
        for m in range(M):
            fire_m = torch.as_tensor(fire[:, m].astype(np.float32), device=device)
            apd_m = torch.as_tensor(apd[:, m].astype(np.float32), device=device)
            ti = (rj / c0 + fire_m[None, :] + (wv.t0 - s0)) * fs  # (I, E)
            i0 = torch.floor(ti)
            u = ti - i0
            idx = torch.clamp(i0.to(torch.int64) + K, 0, G - 1)
            wgt = apd_m[None, :] * w_r
            grid = torch.zeros((G, I), dtype=torch.float32, device=device)
            grid.index_put_((idx, col), wgt * (1 - u), accumulate=True)
            up = idx + 1 < G  # the JAX scatter drops the tap past the end
            grid.index_put_((idx[up] + 1, col[up]), (wgt * u)[up], accumulate=True)
            full = convd(grid, kt, axis=0, shape="full",
                         method="fft" if K > 64 else "direct")
            ps.append(full[K:K + T])  # (T, I)
        p = torch.stack(ps, dim=-1)  # (T, I, M)
        if out == "field":
            return p, s0
        return p.abs().amax(dim=0).reshape(tuple(scan.shape) + (M,))

    # ------------------------------------------------------------ beamformers
    def DAS(self, chd: ChannelData, apod=(), fmod: float = 0.0,
            c0: Optional[Union[float, np.ndarray]] = None,
            keep_tx: bool = False, keep_rx: bool = False,
            method: str = "auto", kernel: str = "auto",
            precision: str = "auto", bsize: Optional[int] = None,
            device=None) -> torch.Tensor:
        """Delay-and-sum beamformer. Returns the image shaped
        ``(*scan.shape, N', M', *F)`` where the rx/tx dims are kept (N/M) or
        summed (1) per the flags, complex64 for complex traces or
        ``fmod != 0`` (IQ data remodulated at ``fmod``), on ``device``.

        ``method``: 'nearest' | 'linear' | 'cubic' | 'lanczos3' | 'cubic2x'
        | 'auto' ('auto' is cubic, the reference default; 'cubic2x' is the
        linear sampler on traces upsampled 2x by ``fft_upsample``).

        ``kernel``: 'auto' runs K1 on a CUDA tensor and the plain path on a
        CPU tensor; 'cuda' requires K1; 'plain' forces the plain path on any
        device. On a CUDA tensor, 'auto' and 'cuda' run frames and ``fmod``
        (K1(b)), the keep modes (K1(c)) and apodization (K1(d): dense arrays
        and :class:`Fused` descriptors, evaluated in the kernel) in the
        kernel, and raise ``NotImplementedError`` for what K1 does not carry
        yet; a per-pixel ``c0`` map (on the scan grid) runs the LUT kernel
        K2 on delay tables built on the card. The kernel takes one ``t0``
        per transmit: one that varies over receivers or frames raises
        ``ValueError``.

        ``apod``: arrays broadcastable to ``(*scan.shape, N, M)`` (e.g. the
        ``ap_*`` generators') and :class:`Fused` descriptors, multiplied
        together. A ``Fused`` takes the kernel's definition
        (``ops.das_cuda.fused_weights``) on K1 and with ``kernel='plain'``;
        on the CPU with ``kernel='auto'`` and with a ``c0`` map it takes
        ``Fused.materialize``'s dense array, as the JAX package's XLA path.

        ``precision``: the taps the kernel reads (K1(e), K2(e) on the
        c0-map route): 'f32', 'bf16pair' (each tap rounded to bfloat16 half
        away from zero, the JAX package's packed pairs), 'bf16' (half to
        even; K1 only: the c0-map route raises ``ValueError``, as
        ``das_lut_plan`` does) or 'i8x4' (int8 taps, one scale per transmit,
        per call on K2; cubic and lanczos3 only, else ``ValueError``);
        'auto' is 'f32' on every device (the JAX package resolves it to
        'bf16pair' on the TPU, where that was measured faster; the port
        changes its default only on a measurement of its own). Weights,
        rotation and sums stay float32; float64, complex128 and bfloat16
        traces are cast to float32 or complex64 before the kernel. With
        ``QUPS_DAS_ACC16=1`` K1 stores its kept sums (``keep_rx``,
        ``keep_tx``) as bfloat16. The plain path ignores ``precision``, as
        the JAX package's XLA path does.

        ``bsize``: stream the traces ``bsize`` transmits at a time: the
        whole trace set stays on the host and one block at a time moves to
        ``device``, where the partial images accumulate.

        ``device``: where to beamform (default: the CUDA device; the traces
        move there, and ``device="cpu"`` runs the plain path on the CPU).

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            b = us.DAS(us.greens(scat, device="cpu"), device="cpu")  # (I1, I2, I3, 1, 1)
            assert b.shape[:3] == us.scan.shape
            img = b.abs().reshape(-1)
            P = us.scan.positions().reshape(3, -1)
            k = int(img.argmax())
            assert np.linalg.norm(P[:, k] - [0, 0, 20e-3]) < 1.1e-3
        """
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if method == "auto":
            method = "cubic"
        pv, nv, model = self._tx_geometry()
        c0v = self.seq.c0 if c0 is None else c0
        cinv = np.reciprocal(np.asarray(c0v, np.float32))
        if cinv.ndim > 1:  # per-pixel map on the scan grid
            cinv = cinv.reshape(-1)
        apod_t = tuple(apod if isinstance(apod, (tuple, list)) else (apod,))
        dev = default_device(device)
        kw = dict(fmod=fmod, keep_tx=keep_tx, keep_rx=keep_rx, method=method,
                  kernel=kernel, precision=precision)
        if np.ndim(cinv) != 0 or (kernel == "auto" and dev.type != "cuda"):
            apod_t = self._materialize(apod_t)
        if bsize is None or chd.M <= bsize:
            return self._das_block(chd.replace(data=chd.data.to(dev)), pv, nv,
                                   model, cinv, apod_t, **kw)
        xh = chd.data.cpu()
        t0b = np.broadcast_to(chd.t0_host, (chd.M,))
        acc, parts = None, []
        for m0 in range(0, chd.M, bsize):
            m1 = min(m0 + bsize, chd.M)
            sub = ChannelData(data=xh[:, :, m0:m1].to(dev), fs=chd.fs,
                              t0=t0b[m0:m1].reshape(1, 1, m1 - m0))
            apod_b = tuple(_slice_tx_apod(a, m0, m1, chd.M) for a in apod_t)
            img = self._das_block(sub, pv[m0:m1], nv[m0:m1], model, cinv,
                                  apod_b, **kw)
            if keep_tx:
                parts.append(img)
            else:
                acc = img if acc is None else acc + img
        return torch.cat(parts, dim=len(self.scan.shape) + 1) if keep_tx else acc

    def _materialize(self, apod_t) -> tuple:
        """``Fused`` descriptors as their dense arrays (``Fused.materialize``),
        as the JAX package's XLA path takes them."""
        return tuple(a.materialize(self) if isinstance(a, Fused) else a for a in apod_t)

    def _fused_operands(self, apod_t) -> dict:
        """The receivers' orientations (2, N) and, on a polar scan with a
        transmit kind, the pixels' lateral coordinate (the angle a, (I,)),
        that K1 and ``fused_weights`` take for ``Fused`` descriptors."""
        fused = [a for a in apod_t if isinstance(a, Fused)]
        if not fused:
            return {}
        az = np.radians(np.asarray(self.rx.orientations()[0], np.float64))
        out = dict(orientations=np.stack([np.sin(az), np.cos(az)]).astype(np.float32))
        if isinstance(self.scan, ScanPolar) and any(a.kind.startswith("tx_") for a in fused):
            lat = np.broadcast_to(_place(self.scan.a, self.scan.order.index("A"), 3),
                                  self.scan.shape)
            out["lat"] = lat.reshape(-1).astype(np.float32)
        return out

    def _das_block(self, chd: ChannelData, pv, nv, model, cinv, apod_t, *,
                   fmod, keep_tx, keep_rx, method, kernel, precision):
        """One DAS dispatch over a (possibly tx-sliced) trace block."""
        if method == "cubic2x":
            # the linear sampler on traces upsampled 2x, band-limited, as
            # the JAX package's cubic2x
            chd = chd.replace(data=fft_upsample(chd.data, 2, axis=0), fs=chd.fs * 2.0)
            method = "linear"
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; expected {METHODS}")
        x = chd.data
        pi, pr = self._pixels(), self.rx.positions().T
        im_shape = tuple(self.scan.shape)
        fk = self._fused_operands(apod_t)
        if kernel == "cuda" or (kernel == "auto" and x.is_cuda):
            if not x.is_cuda:
                raise ValueError("kernel='cuda' needs the traces on a CUDA device")
            if np.ndim(cinv) != 0:
                # a per-pixel sound-speed map: per-pixel delay tables, built
                # on the device, ride the LUT kernel K2
                pig = as_f32(pi, x.device)
                cv = as_f32(cinv, x.device).reshape(-1, 1)
                pvg, nvg = as_f32(pv, x.device), as_f32(nv, x.device)
                tau_rx = rx_distance(pig, as_f32(pr, x.device)) * cv
                tau_tx = torch.stack([tx_distance(pig, pvg[m], nvg[m], model)
                                      for m in range(pvg.shape[0])], 1) * cv
                return self.bfDASLUT(chd, tau_rx, tau_tx, apod=apod_t, fmod=fmod,
                                     keep_tx=keep_tx, keep_rx=keep_rx,
                                     method=method, kernel=kernel,
                                     precision=precision, device=x.device)
            img = das_sum(x, pi, pr, pv, nv, chd.t0, cinv, fs=float(chd.fs),
                          tx_model=model, method=method, fmod=float(fmod), apod=apod_t,
                          keep_rx=keep_rx, keep_tx=keep_tx, im_shape=im_shape,
                          precision=_kernel_precision(precision), **fk)
        else:
            img = das(x, pi, pr, pv, nv, chd.t0_host, cinv, fs=float(chd.fs),
                      apod=dense_apod(apod_t, pi, pr, nv, im_shape=im_shape,
                                      device=x.device, **fk),
                      fmod=float(fmod), tx_model=model, keep_rx=keep_rx,
                      keep_tx=keep_tx, method=method, im_shape=im_shape)
        return img.reshape(tuple(self.scan.shape) + tuple(img.shape[1:]))

    def coherence_image(self, chd: ChannelData, post: str = "cohfac", lags=None,
                        apod=(), fmod: float = 0.0, c0: Optional[float] = None,
                        method: str = "auto", precision: str = "auto", mesh=None,
                        kernel: str = "auto", device=None) -> torch.Tensor:
        """Aperture-coherence image: :meth:`DAS` with ``keep_rx=True`` (K1(c)
        on the card), then the reduction over the receive aperture on the
        same device, ``post='cohfac'`` (the magnitude of
        :func:`~qups_tpu_torch.ops.coherence.cohfac`) or ``'slsc'``
        (:func:`~qups_tpu_torch.ops.coherence.slsc` with ``lags``). Returns
        ``(*scan.shape, *F)``: one image per frame (the JAX package's
        two-step path sums the frames first).

        ``precision``: as for :meth:`DAS` ('auto' is 'f32'; 'bf16pair',
        'bf16', 'i8x4' on K1(e)). ``mesh`` (several cards) is not ported and
        raises. ``kernel`` and ``device`` as for :meth:`DAS`.

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=8),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            cf = us.coherence_image(us.greens(scat, device="cpu"), device="cpu")
            assert cf.shape == us.scan.shape
            assert bool(cf.isfinite().all()) and float(cf.max()) <= 1.0 + 1e-6
        """
        if post not in ("cohfac", "slsc"):
            raise ValueError(f"unknown post {post!r}")
        if mesh is not None:
            raise NotImplementedError("coherence_image on a mesh of cards is not ported "
                                      "(ROADMAP Queue 1 item 11)")
        brx = self.DAS(chd, apod=apod, fmod=fmod, c0=c0, keep_rx=True, method=method,
                       kernel=kernel, precision=precision, device=device)
        nd = len(self.scan.shape)
        brx = brx.select(nd + 1, 0)  # (*scan.shape, N, *F)
        if post == "cohfac":
            return cohfac(brx, axis=nd).abs()
        return slsc(brx, axis=nd, lags=lags)

    # ------------------------------------------------------- LUT beamformers
    def das_delay_tables(self, c0: Optional[float] = None, device=None):
        """Separable geometric delay tables ``(tau_rx (I, N), tau_tx
        (I, M))`` in seconds for this system, float32 on ``device`` (default
        the CUDA device), as :meth:`bfDAS` uses them."""
        device = default_device(device)
        pv, nv, model = self._tx_geometry()
        c0v = float(c0 if c0 is not None else self.seq.c0)
        return delay_tables(self._pixels(), self.rx.positions().T, pv, nv, c0v,
                            tx_model=model, device=device)

    def bfDAS(self, chd: ChannelData, apod=(), fmod: float = 0.0,
              c0: Optional[float] = None, keep_tx: bool = False,
              keep_rx: bool = False, method: str = "auto",
              kernel: str = "auto", precision: str = "auto",
              device=None) -> torch.Tensor:
        """Delay-and-sum through delay tables: :meth:`das_delay_tables`,
        built on ``device`` (default: the CUDA device), then
        :meth:`bfDASLUT` there (kernel K2 on a CUDA tensor).

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.greens(scat, device="cpu")
            b1 = us.bfDAS(chd, device="cpu").reshape(-1)
            b2 = us.DAS(chd, device="cpu").reshape(-1)
            c = abs(complex((b1.conj() * b2).sum())) / float(b1.norm() * b2.norm())
            assert c > 0.99
        """
        tau_rx, tau_tx = self.das_delay_tables(c0=c0, device=device)
        return self.bfDASLUT(chd, tau_rx, tau_tx, apod=apod, fmod=fmod,
                             keep_tx=keep_tx, keep_rx=keep_rx, method=method,
                             kernel=kernel, precision=precision, device=device)

    def bfDASLUT(self, chd: ChannelData, tau_rx, tau_tx, apod=(),
                 fmod: float = 0.0, keep_tx: bool = False,
                 keep_rx: bool = False, method: str = "auto",
                 kernel: str = "auto", precision: str = "auto",
                 device=None) -> torch.Tensor:
        """Beamform from arbitrary delay tables ("bring your own delays"):
        ``tau = (tau_tx[i, m] + tau_rx[i, n]) - t0[m]`` with ``tau_rx
        (I, N)`` and ``tau_tx (I, M)`` in seconds (numpy or tensors), the
        samples remodulated at ``fmod``. Returns the image ``(*scan.shape,
        N', M', *F)`` on ``device`` (default: the CUDA device; the traces
        move there, and ``device="cpu"`` runs the plain path on the CPU).

        ``kernel``: 'auto' runs K2 on a CUDA tensor and the plain ``das_lut``
        on a CPU tensor; 'cuda' requires K2; 'plain' forces the plain path.
        On a CUDA tensor, frames and ``fmod`` (K2(b)), the keep modes and
        dense ``apod`` arrays (K2(c)) run in K2, a ``t0`` that varies over
        receivers or frames raises ``ValueError``, and options K2 does not
        carry yet raise ``NotImplementedError`` naming the sub-slice. A
        :class:`Fused` descriptor raises ``TypeError`` (materialize it).
        ``method``: the four samplers or 'cubic2x' (linear on traces
        upsampled 2x), 'auto' is cubic. ``precision``: the taps K2 reads
        (K2(e)): 'auto' and 'f32', 'bf16pair', or 'i8x4' with one scale per
        call (cubic and lanczos3 only); 'bf16' raises ``ValueError``, as the
        JAX package's ``das_lut_plan``. The plain path ignores it.

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            chd = us.greens(scat, device="cpu")
            tau_rx, tau_tx = us.das_delay_tables(device="cpu")  # or eikonal, ...
            b = us.bfDASLUT(chd, tau_rx, tau_tx, device="cpu")
            assert b.shape[:3] == us.scan.shape
        """
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        if method == "auto":
            method = "cubic"
        chd = chd.replace(data=chd.data.to(default_device(device)))
        if method == "cubic2x":
            chd = chd.replace(data=fft_upsample(chd.data, 2, axis=0), fs=chd.fs * 2.0)
            method = "linear"
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; expected {METHODS}")
        apod_t = tuple(apod if isinstance(apod, (tuple, list)) else (apod,))
        if any(isinstance(a, Fused) for a in apod_t):
            raise TypeError("bfDASLUT takes dense apodization arrays, as the JAX package's "
                            "das_lut; materialize a Fused descriptor first "
                            "(Fused.materialize)")
        x = chd.data
        if kernel == "cuda" or (kernel == "auto" and x.is_cuda):
            if not x.is_cuda:
                raise ValueError("kernel='cuda' needs the traces on a CUDA device")
            img = das_lut_sum(x, tau_rx, tau_tx, chd.t0, fs=float(chd.fs),
                              method=method, fmod=float(fmod), apod=apod_t,
                              keep_rx=keep_rx, keep_tx=keep_tx,
                              im_shape=tuple(self.scan.shape),
                              precision=_kernel_precision(precision))
        else:
            img = das_lut(x, tau_rx, tau_tx, chd.t0_host, fs=float(chd.fs),
                          apod=apod_t, fmod=float(fmod), keep_rx=keep_rx,
                          keep_tx=keep_tx, method=method,
                          im_shape=tuple(self.scan.shape))
        return img.reshape(tuple(self.scan.shape) + tuple(img.shape[1:]))

    # ------------------------------------------- frequency-domain beamformer
    def bfAdjoint(self, chd: ChannelData, apod=(), fmod: float = 0.0,
                  c0: Optional[float] = None, fthresh_db: float = -40.0,
                  max_bins: Optional[int] = None, keep_rx: bool = False,
                  keep_tx: bool = False, bins=None, kernel: str = "auto",
                  precision: str = "bf16", device=None) -> torch.Tensor:
        """Frequency-domain adjoint beamformer: per selected bin, the
        transmit steering ``A = Wtx S_k``, its power normalization, and the
        receive adjoint ``Wrx X_k`` contracted with ``conj(Ahat)``. Returns
        the image ``(*scan.shape, N', M', *F)`` (``N' = N`` with keep_rx,
        ``M' = M`` with keep_tx, else 1).

        The bins are the positive-frequency bins within ``fthresh_db`` of
        the spectral peak (the strongest ``max_bins`` of them), chosen on
        the data's device with one (T,) download; ``bins`` (int indices,
        entries < 0 skipped) bypasses the choice. ``apod`` is accepted for
        the JAX signature and, as there, unused.

        ``kernel``: 'auto' runs K4 on a CUDA tensor and the plain version on
        a CPU tensor; 'cuda' requires K4; 'plain' forces the plain version.
        ``precision``: 'bf16' (default; the operands of the products
        rounded to bfloat16, sums in float32) or 'f32', on either path.
        ``device``: where to beamform (default: the CUDA device; the traces
        move there, and ``device="cpu"`` runs the plain version on the
        CPU).

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(18e-3, 22e-3, 8)),
                fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            b = us.bfAdjoint(us.greens(scat, device="cpu"), device="cpu")
            img = b.abs().squeeze()
            assert img.shape == (8, 8) and bool(img.isfinite().all())
        """
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}")
        dev = default_device(device)
        data = chd.data.to(dev)
        use_cuda = kernel == "cuda" or (kernel == "auto" and data.is_cuda)
        if use_cuda and not data.is_cuda:
            raise ValueError("kernel='cuda' needs the traces on a CUDA device")
        tau_rx, tau_tx = self._adjoint_tables(
            float(c0 if c0 is not None else self.seq.c0), dev)
        t0_off = np.broadcast_to(self.seq.t0_offset(), (self.seq.num_pulse,))
        del_tx = self.seq.delays(self.tx) + t0_off[None, :]  # (M, V)
        apod_tx = self.seq.apodization(self.tx)             # (M, V)
        if bins is not None:
            sel = np.asarray(bins, np.int32).reshape(-1)
        else:
            sel = select_fbins(data, chd.fs, fthresh_db, max_bins)
        engine = bf_adjoint_cuda if use_cuda else bf_adjoint
        kw = dict(fs=float(chd.fs), fmod=float(fmod), keep_rx=keep_rx,
                  keep_tx=keep_tx, precision=precision)
        args = (tau_rx, tau_tx, del_tx, apod_tx, chd.t0_host, t0_off, sel)
        fdims = tuple(data.shape[3:])
        if fdims:  # trailing frame dims fold to one axis, one call per frame
            xF = data.reshape(tuple(data.shape[:3]) + (-1,))
            b = torch.stack([engine(xF[..., f], *args, **kw)
                             for f in range(xF.shape[-1])], dim=-1)
            b = b.reshape(tuple(b.shape[:-1]) + fdims)
        else:
            b = engine(data, *args, **kw)
        kept = (chd.N, 1) if keep_rx else ((1, chd.M) if keep_tx else (1, 1))
        return b.reshape(tuple(self.scan.shape) + kept + fdims)

    def _adjoint_tables(self, c0: float, device):
        """The (I, N) and (I, M) element delay tables of :meth:`bfAdjoint`,
        built on ``device``. They do not depend on the data, so repeated
        frames take them from a cache bounded by bytes."""
        pi32 = np.ascontiguousarray(self._pixels(), np.float32)
        prx = np.ascontiguousarray(self.rx.positions().T, np.float32)
        ptx = np.ascontiguousarray(self.tx.positions().T, np.float32)
        dev = torch.device(device)
        key = (hashlib.sha1(pi32.tobytes() + prx.tobytes() + ptx.tobytes())
               .hexdigest(), c0, str(dev))
        hit = _ADJ_TAU_CACHE.get(key)
        if hit is not None:
            return hit
        cinv = np.float32(1.0 / c0)
        tabs = (geom_delays(pi32, prx, cinv, dev), geom_delays(pi32, ptx, cinv, dev))
        nb = 4 * (tabs[0].numel() + tabs[1].numel())
        if nb <= _ADJ_TAU_CACHE_MAX_BYTES:  # 0 disables the cache
            while _ADJ_TAU_CACHE and nb + sum(
                    4 * (a.numel() + b.numel())
                    for a, b in _ADJ_TAU_CACHE.values()) > _ADJ_TAU_CACHE_MAX_BYTES:
                _ADJ_TAU_CACHE.pop(next(iter(_ADJ_TAU_CACHE)))
            _ADJ_TAU_CACHE[key] = tabs
        return tabs


# bfAdjoint's (I, N) / (I, M) device delay tables, ~2 GB at 1024^2 x 256 x 256
_ADJ_TAU_CACHE: dict = {}
_ADJ_TAU_CACHE_MAX_BYTES = int(os.environ.get("QUPS_ADJ_TAU_CACHE_BYTES",
                                              str(4 * 1024**3)))


def _slice_tx_apod(a, m0, m1, M):
    """Slice the transmit axis of one apodization for a ``bsize`` block:
    a dense array when its axis 4 spans all M transmits; a :class:`Fused`
    with a per-transmit ``lat_tx`` of M values is rebuilt with the block's
    slice (the other Fused are pure geometry and pass through)."""
    if isinstance(a, Fused):
        lt = a.p.get("lat_tx")
        if lt is not None and np.ndim(lt) and np.shape(lt)[0] == M:
            return Fused(a.kind, **dict(a.p, lat_tx=np.asarray(lt)[m0:m1]))
        return a
    a = a if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.ndim >= 5 and a.shape[4] == M:
        return a[:, :, :, :, m0:m1]
    return a


# ----------------------------------------------------------------------------
# Apodization generators: geometry masks and weights broadcastable to
# (I1, I2, I3, N, M), host numpy in float64, returned as float32, as the JAX
# package's (qups_tpu/system.py).
# ----------------------------------------------------------------------------
def _place(vec, dim, ndim=5):
    """Place a 1-D vector along dimension ``dim`` of an ndim-D array."""
    v = np.asarray(vec)
    shape = [1] * ndim
    shape[dim] = v.size
    return v.reshape(shape)


def _lat_axis(scan):
    """(values, data dim) of the lateral axis: x (cartesian) or a (polar)."""
    if isinstance(scan, ScanCartesian):
        return scan.x, scan.order.index("X")
    if isinstance(scan, ScanPolar):
        return scan.a, scan.order.index("A")
    raise TypeError(f"unsupported scan type {type(scan).__name__}")


def _lat_tx(us):
    """Per-transmit lateral coordinate: the focus x (cartesian) or angle."""
    if isinstance(us.scan, ScanPolar):
        return np.degrees(np.arctan2(us.seq.focus_array[0] - us.scan.origin[0],
                                     us.seq.focus_array[2] - us.scan.origin[2]))
    return us.seq.focus_array[0]


def _ap_scanline(us, tol: Optional[float] = None) -> np.ndarray:
    """Scanline matching for focused line-by-line imaging: pixels whose
    lateral coordinate is within ``tol`` (default: the lateral step) of
    each transmit's. Returns an (I1, I2, I3, 1, M)-broadcastable mask."""
    xi, xdim = _lat_axis(us.scan)
    xv = _lat_tx(us)
    if tol is None:
        d = np.diff(xi)
        tol = float(d[0]) if d.size else np.inf
    return (np.abs(_place(xi, xdim) - _place(xv, 4)) < tol).astype(np.float32)


def _ap_multiline(us) -> np.ndarray:
    """Linear interpolation between the two nearest transmit scanlines."""
    xi, xdim = _lat_axis(us.scan)
    xv = _lat_tx(us)
    M, X = xv.size, xi.size
    apod = np.zeros((X, M), np.float32)
    order = np.argsort(xv)
    xs = xv[order]
    for ix, x in enumerate(xi):
        li = np.searchsorted(xs, x, side="right") - 1  # the last xs <= x
        ri = np.searchsorted(xs, x, side="left")       # the first xs >= x
        if li < 0 or ri >= M:
            continue  # outside the transmits' span
        d = xs[ri] - xs[li]
        if d == 0:
            apod[ix, order[li]] += 1.0
        else:
            apod[ix, order[li]] += 1.0 - abs(xs[li] - x) / d
            apod[ix, order[ri]] += 1.0 - abs(xs[ri] - x) / d
    shape = [1] * 5
    shape[xdim], shape[4] = X, M
    return apod.reshape(shape)


def _ap_translating_aperture(us, tol=None) -> np.ndarray:
    """Receive aperture translating with the transmit scanline: pixels
    within ``tol[0]`` of the transmit's lateral position and receivers
    within ``tol[1]`` of the pixel's (default: the lateral step)."""
    xi, xdim = _lat_axis(us.scan)
    xv = _lat_tx(us)
    xn = np.asarray(us.rx.orientations()[0]) if isinstance(us.scan, ScanPolar) \
        else us.rx.positions()[0]
    if tol is None:
        d = np.diff(xi)
        tol = (float(d[0]) if d.size else np.inf,) * 2
    tol = np.broadcast_to(np.atleast_1d(tol), (2,))
    m = (np.abs(_place(xi, xdim) - _place(xv, 4)) <= tol[0]) \
        & (np.abs(_place(xi, xdim) - _place(xn, 3)) <= tol[1])
    return m.astype(np.float32)


def _ap_aperture_growth(us, f: float = 1.5, Dmax: float = np.inf) -> np.ndarray:
    """F-number-limited aperture growth: receiver n takes pixel i when
    ``z > f |2 d|`` with ``d`` the (element-frame) lateral offset, and
    ``|2 d| < Dmax``. Returns (I1, I2, I3, N, 1)."""
    pn = us.rx.positions()
    P = us.scan.positions()
    Xi, Zi = P[0][..., None], P[2][..., None]
    Xn, Zn = pn[0].reshape(1, 1, 1, -1), pn[2].reshape(1, 1, 1, -1)
    th = us.rx.orientations()[0]
    if np.any(np.abs(th) > 1e-12):  # a non-planar array (convex)
        ae = np.radians(th).reshape(1, 1, 1, -1)
        rp = np.hypot(Xi - Xn, Zi - Zn)
        ap = np.arctan2(Xi - Xn, Zi - Zn)
        d = rp * np.sin(ap - ae)
        z = np.abs(rp * np.cos(ap - ae))
    else:
        d = Xn - Xi
        z = Zi
    m = (z > f * np.abs(2 * d)) & (np.abs(2 * d) < Dmax)
    return m.astype(np.float32)[..., None]


def _ap_tx_parallelogram(us, theta=None, phi=(0.0, 0.0)) -> np.ndarray:
    """Plane-wave parallelogram: pixels whose projection along the steering
    direction (within the spread ``phi``) lands inside the transducer's
    bounds. Returns (I1, I2, I3, 1, M)."""
    fx = us.seq.focus_array
    if theta is None:
        theta = np.degrees(np.arctan2(fx[0], fx[2]))
    theta = np.atleast_1d(theta)
    M = theta.size
    P = us.scan.positions()
    pb = us.xdc.bounds()
    ok = None
    for ph in phi:
        ang = np.radians(theta + ph)
        nvx, nvz = np.sin(ang).reshape(1, 1, 1, M), np.cos(ang).reshape(1, 1, 1, M)
        x0 = P[0][..., None] - nvx * (P[2][..., None] / nvz)  # projected to z = 0
        mk = (pb[0, 0] < x0) & (x0 <= pb[0, 1])
        ok = mk if ok is None else ok | mk
    return ok.astype(np.float32)[:, :, :, None, :]


def _rx_pixel_cos(us):
    """<element normal, unit(pixel - element)>, (I1, I2, I3, N)."""
    pn = us.rx.positions()
    nn = us.rx.orientations()[2]
    P = us.scan.positions()
    r = P[:, :, :, :, None] - pn[:, None, None, None, :]
    r = r / np.maximum(np.linalg.norm(r, axis=0, keepdims=True), 1e-30)
    return np.einsum("cn,cijkn->ijkn", nn, r)


def _ap_acceptance_angle(us, theta: float = 45.0) -> np.ndarray:
    """Element acceptance angle: ``<n, r_hat> >= cos(theta)``."""
    return (_rx_pixel_cos(us) >= np.cos(np.radians(theta))).astype(np.float32)[..., None]


def _ap_cosine_angle(us, theta: float = 45.0) -> np.ndarray:
    """Cosine taper over the receiver-to-pixel angle,
    ``cos(min(90, 90 / theta * angle))``."""
    ang = np.degrees(np.arccos(np.clip(_rx_pixel_cos(us), -1.0, 1.0)))
    w = np.cos(np.radians(np.minimum(90.0, (90.0 / theta) * ang)))
    return w.astype(np.float32)[..., None]


UltrasoundSystem.ap_scanline = _ap_scanline
UltrasoundSystem.ap_multiline = _ap_multiline
UltrasoundSystem.ap_translating_aperture = _ap_translating_aperture
UltrasoundSystem.ap_aperture_growth = _ap_aperture_growth
UltrasoundSystem.ap_tx_parallelogram = _ap_tx_parallelogram
UltrasoundSystem.ap_acceptance_angle = _ap_acceptance_angle
UltrasoundSystem.ap_cosine_angle = _ap_cosine_angle
