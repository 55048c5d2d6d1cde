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
:meth:`UltrasoundSystem.bfDASLUT`, :meth:`UltrasoundSystem.bfAdjoint`,
:meth:`UltrasoundSystem.bfMigration` (Stolt f-k migration) and, through a
heterogeneous :class:`Medium`, :meth:`UltrasoundSystem.bfEikonal`; decode
synthesized transmits back to FSA with :meth:`UltrasoundSystem.refocus`;
simulate the full wave through a :class:`Medium` with
:meth:`UltrasoundSystem.kspaceFirstOrder`.
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
  kernel K4 (``ops/fdbf_cuda.py``) at any number of pulses and receivers;
  ``bfEikonal`` builds its tables by fast marching on the host
  (``ops/eikonal.py``, through a :class:`Medium`'s sound-speed map) and
  runs K2 through ``bfDASLUT``. Every option of these kernels runs on the
  card. ``refocus``, ``bfMigration`` and ``kspaceFirstOrder`` reach no TPU
  kernel in the JAX package; they are ``torch.fft``, ``torch.linalg`` and
  elementwise code on the card. Nothing drops to the plain path on its
  own: ``kernel='plain'`` is an explicit choice. With ``device="cpu"`` each runs its plain PyTorch
  version.
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
from .core.medium import Medium
from .core.scan import Scan, ScanCartesian, ScanPolar
from .core.scat import Scatterers
from .core.seq import Sequence
from .core.xdc import Transducer, TransducerArray, TransducerConvex
from .ops.das import das, das_lut, delay_tables, rx_distance, tx_distance
from .ops.das_cuda import Fused, das_lut_sum, das_sum, dense_apod
from .ops.eikonal import msfm, msfm_multi
from .ops.coherence import cohfac, slsc
from .ops.conv import convd
from .ops.fdbf import (bf_adjoint, focus_tx_freq, geom_delays, refocus_apply, refocus_op,
                       select_fbins, stolt_migration)
from .ops.fdbf_cuda import bf_adjoint_cuda
from .ops.greens import greens_dense, greens_splat
from .ops.greens_cuda import greens_tiled
from .ops.greens_freq import greens_freq
from .ops.interp import METHODS, fft_upsample
from .ops.simus import simus_fsa
from .parallel.mesh import (Mesh, das_sharded_pallas, fdtd_sharded, greens_freq_sharded,
                            greens_sharded)
from .sim.fdtd import batch_chunk, kspace_sim_2d, kspace_sim_3d
from .utils.backend import as_f32, default_device
from .utils.maths import box_rbounds, gridded_interp, next_pow2
from .utils.profiling import annotate

PRECISIONS = ("auto", "f32", "bf16pair", "i8x4", "bf16")
KERNELS = ("auto", "cuda", "plain")


def _mesh_device(mesh) -> torch.device:
    """The first device of a :class:`~qups_tpu_torch.parallel.Mesh`, where a
    sharded call's result lives; ``TypeError`` for anything else."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a qups_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh.devices.flat[0]


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
               kernel: str = "auto", device=None, mesh=None) -> ChannelData:
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

        ``mesh``: a :class:`~qups_tpu_torch.parallel.Mesh` with 'rx'/'tx'
        axes: the simulation shards scatterers over 'tx' and receive
        elements over 'rx' (:func:`~qups_tpu_torch.parallel.greens_freq_sharded`
        for 'freq', ``kernel`` its ``engine``;
        :func:`~qups_tpu_torch.parallel.greens_sharded` for 'splat'; any
        other ``impl`` raises ``ValueError``), and the traces live on the
        mesh's first device, in place of ``device``.

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
        with annotate("qups.greens"):
            device = _mesh_device(mesh) if mesh is not None else default_device(device)
            on_cpu = device.type == "cpu"
            if impl == "auto":
                impl = "splat" if on_cpu else "freq"
            if impl not in ("freq", "pallas", "splat", "dense"):
                raise ValueError(f"unknown impl {impl!r}")
            if mesh is not None and impl not in ("freq", "splat"):
                raise ValueError(f"greens(mesh=...) shards impl='freq'|'splat' only; "
                                 f"impl={impl!r} would silently run single-device")
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
                fkw = dict(rtol=rtol, precision=precision, alpha0=float(scat.alpha0), **kw)
                if mesh is not None:
                    x = greens_freq_sharded(mesh, kern, ps, scat.amp, pn, pv, engine=kernel, **fkw)
                else:
                    x = greens_freq(kern, ps, scat.amp, pn, pv, kernel=kernel, device=device,
                                    **fkw)
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
            kw.update(method=method)
            if impl == "splat" and mesh is not None:
                x = greens_sharded(mesh, kern, ps, scat.amp, pn, pv, block=block, **kw)
            elif impl == "splat":
                x = greens_splat(kern, ps, scat.amp, pn, pv, block=block, device=device, **kw)
            else:
                x = greens_dense(kern, ps, scat.amp, pn, pv, device=device, **kw)
            chd = ChannelData(data=x, fs=fs, t0=s0)
            return self.focusTx(chd, self.seq, method=fmethod, device=device)

    def _greens_problem(self, scat: Scatterers,
                        element_subdivisions: Tuple[int, int] = (1, 1),
                        R0: Optional[float] = None, fsk: Optional[float] = None):
        """Host-side set-up of :meth:`greens`: scatterer positions (S, 3),
        the convolved kernel, rx/tx sub-element positions (N|M, E, 3) and
        the simulators' keyword arguments (T, s0, t0k, fs, cinv, R0, fsr)."""
        with annotate("qups.greens.problem"):
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
        with annotate("qups.focus_tx.plan"):
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
        with annotate("qups.focus_tx"):
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
        so this runs one FSA :meth:`greens` (keyword arguments pass through,
        ``mesh`` among them) and folds the sequence ``bsize`` transmits at a
        time, or all at once when ``None``. ``method`` goes to :meth:`greens`
        as given; for the
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
            mesh = kw.get("mesh")
            dev = _mesh_device(mesh) if mesh is not None else default_device(kw.get("device"))
            method = "cubic" if dev.type == "cpu" else "freq"
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
        kernel; a per-pixel ``c0`` map (on the scan grid) runs the LUT kernel
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
        with annotate("qups.das"):
            if method == "auto":
                method = "cubic"
            with annotate("qups.das.geometry"):
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
        with annotate("qups.das.geometry"):
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
        'bf16', 'i8x4' on K1(e)). ``kernel`` and ``device`` as for
        :meth:`DAS`.

        ``mesh``: a :class:`~qups_tpu_torch.parallel.Mesh` with 'rx'/'tx'
        axes. When the call is eligible (no apodization or only ``Fused``
        descriptors, a scalar sound speed, (T, N, M) traces, one of the four
        samplers) the reduction runs in the mesh:
        :func:`~qups_tpu_torch.parallel.das_sharded_pallas` with ``post``
        (K1(c) per shard; ``precision`` 'f32' or 'bf16pair'), the image on the
        mesh's first device. Otherwise the two steps above run on the traces'
        device, as the JAX package falls back.

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
            _mesh_device(mesh)
            apod_t = tuple(apod if isinstance(apod, (tuple, list)) else (apod,))
            m = "cubic" if method == "auto" else method
            c0v = self.seq.c0 if c0 is None else c0
            if (all(isinstance(a, Fused) for a in apod_t) and np.ndim(c0v) == 0
                    and chd.data.ndim == 3 and m in METHODS):
                pv, nv, model = self._tx_geometry()
                img = das_sharded_pallas(
                    mesh, chd.data, self._pixels(), self.rx.positions().T, pv, nv,
                    chd.t0_host, np.reciprocal(np.float32(c0v)), fs=float(chd.fs),
                    tx_model=model, im_shape=tuple(self.scan.shape), method=m,
                    apod=apod_t, fmod=float(fmod), precision=_kernel_precision(precision),
                    post=post, lags=lags, **self._fused_operands(apod_t))
                return img.reshape(self.scan.shape)
            device = chd.data.device
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
        dense ``apod`` arrays (K2(c)) run in K2, and a ``t0`` that varies
        over receivers or frames raises ``ValueError``. A :class:`Fused`
        descriptor raises ``TypeError`` (materialize it).
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
            float(c0 if c0 is not None else self_c0(self)), dev)
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

    # ------------------------------------------- REFoCUS and Stolt migration
    def refocus(self, chd: ChannelData, seq: Optional[Sequence] = None,
                gamma: Optional[float] = None, method: str = "tikhonov",
                device=None) -> ChannelData:
        """Decode synthesized transmits back to FSA (REFoCUS,
        ``UltrasoundSystem.refocus``, ``src/UltrasoundSystem.m:3505-3768``):
        per frequency the whitened inverse of the encoding of ``seq``
        (default: this system's) by 'tikhonov' (``gamma``, default
        ``10 (M / 10)^2``), 'adjoint' or 'pinv'
        (:func:`~qups_tpu_torch.ops.fdbf.refocus_op`), then the per-bin
        transmit GEMM and the inverse FFT
        (:func:`~qups_tpu_torch.ops.fdbf.refocus_apply`), on ``device``
        (default: the CUDA device; the traces move there). Trailing frame
        dims pass through. Returns (T, N, M, *F) complex traces with ``t0``
        the least pulse start.

        The decode operator depends on the sequence, T, fs, gamma, method
        and device, not on the data: repeated decodes take it from a FIFO
        cache bounded by bytes (``QUPS_REFOCUS_CACHE_BYTES``, 3 GiB).

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=[0.0], z=[20e-3]), fs=12e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            fsa = us.greens(scat, device="cpu")
            pw = q.SequenceRadial(type="PW", angles=np.linspace(-10, 10, 4), c0=1540.0)
            enc = us.focusTx(fsa, pw, device="cpu")
            dec = us.replace(seq=pw).refocus(enc, device="cpu")
            assert dec.data.shape[2] == 4 and bool(dec.data.isfinite().all())
        """
        seq = seq or self.seq
        dev = default_device(device)
        tau = np.asarray(seq.delays(self.tx), np.float32)       # (M, V)
        apd = np.asarray(seq.apodization(self.tx), np.float32)  # (M, V)
        t0 = chd.t0_host
        t0v = np.broadcast_to(t0, (chd.M,)) if t0.size == 1 else t0
        key = (hashlib.sha1(tau.tobytes() + apd.tobytes()).hexdigest(), int(chd.T),
               float(chd.fs), None if gamma is None else float(gamma), method, str(dev))
        Hi = _REFOCUS_OP_CACHE.get(key)
        if Hi is None:
            Hi = refocus_op(tau, apd, T=int(chd.T), fs=float(chd.fs), gamma=gamma,
                            method=method, device=dev)
            nb = Hi.numel() * Hi.element_size()
            while _REFOCUS_OP_CACHE and nb + sum(
                    v.numel() * v.element_size()
                    for v in _REFOCUS_OP_CACHE.values()) > _REFOCUS_OP_CACHE_MAX_BYTES:
                _REFOCUS_OP_CACHE.pop(next(iter(_REFOCUS_OP_CACHE)))
            _REFOCUS_OP_CACHE[key] = Hi
        y, _ = refocus_apply(chd.data, Hi, t0v, fs=float(chd.fs), device=dev)
        return chd.replace(data=y, t0=float(t0v.min()))

    def bfMigration(self, chd: ChannelData, c0: Optional[float] = None, fmod: float = 0.0,
                    keep_tx: bool = False, method: str = "cubic", jacobian: bool = True,
                    resample: bool = True, nfft: Optional[Tuple[int, int]] = None,
                    device=None):
        """Stolt f-k plane-wave migration (``UltrasoundSystem.bfMigration``,
        ``src/UltrasoundSystem.m:4675-4887``) on ``device`` (default: the
        CUDA device; the traces move there). Needs a PW sequence on a
        :class:`TransducerArray`. A t0 that varies by transmit is rectified
        first (``ChannelData.rectifyt0``), and the start time is realized as
        leading zeros; the FFT sizes default to the next powers of two of
        2T and 2N. Returns ``(b, bscan)``: ``bscan`` is the image's native
        cartesian scan (z from the two-way time axis, x at the elements);
        with ``resample=True``, ``b`` is bilinearly resampled onto
        ``us.scan`` on the device, ``(*scan.shape, 1, M', *F)`` (``M' = M``
        with ``keep_tx``, else 1), else ``b`` is the native
        ``(T, N, M', *F)`` image.

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.SequenceRadial(type="PW", angles=[0.0], c0=1540.0),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 9),
                                     z=np.linspace(18e-3, 22e-3, 9)), fs=24e6)
            scat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
            b, bscan = us.bfMigration(us.greens(scat, device="cpu"), device="cpu")
            assert b.shape == us.scan.shape + (1, 1) and bool(b.isfinite().all())
        """
        if self.seq.type != "PW":
            raise ValueError("bfMigration requires a plane-wave sequence")
        if not isinstance(self.xdc, TransducerArray):
            raise TypeError("bfMigration requires a TransducerArray")
        dev = default_device(device)
        chd = chd.replace(data=chd.data.to(dev))
        c0v = float(c0 if c0 is not None else self.seq.c0)
        t0 = chd.t0_host
        if t0.size > 1 and not np.allclose(t0, t0[0]):
            chd = chd.rectifyt0()
            t0 = chd.t0_host
        # a large t0 as a pure phase ramp oscillates faster than the DFT bin
        # spacing and would be destroyed by the frequency-axis resampling
        pre = int(round(float(t0[0]) * chd.fs))
        if pre > 0:
            chd = chd.zeropad(pre, 0)
            t0 = chd.t0_host
        f = self.seq.focus_array
        angles = np.degrees(np.arctan2(f[0], f[2]))
        del_tx = self.seq.delays(self.xdc)  # (N, M)
        if nfft is None:
            nfft = (next_pow2(2 * chd.T), next_pow2(2 * chd.N))
        b = stolt_migration(chd.data, t0, del_tx, tuple(angles), fs=float(chd.fs), c0=c0v,
                            pitch=float(self.xdc.pitch), fmod=float(fmod), keep_tx=keep_tx,
                            method=method, jacobian=jacobian, nfft=tuple(nfft), device=dev)
        pn = self.xdc.positions()
        zax = self.xdc.offset[2] + c0v / 2 * (float(t0[0]) + np.arange(chd.T) / chd.fs)
        bscan = ScanCartesian(x=pn[0], y=[self.xdc.offset[1]], z=zax)
        if not resample:
            return b, bscan
        # bilinear resample onto the scan, on the device
        P = self.scan.positions()
        zi = as_f32(((P[2] - zax[0]) / (zax[1] - zax[0])).reshape(-1), dev)
        xi = as_f32(((P[0] - pn[0, 0]) / self.xdc.pitch).reshape(-1), dev)
        Tn, Nn = b.shape[:2]
        z0 = torch.clamp(torch.floor(zi).long(), 0, Tn - 1)
        x0 = torch.clamp(torch.floor(xi).long(), 0, Nn - 1)
        z1, x1 = torch.clamp(z0 + 1, 0, Tn - 1), torch.clamp(x0 + 1, 0, Nn - 1)
        nb = b.ndim - 2
        wz = torch.clamp(zi - z0, 0, 1).reshape((-1,) + (1,) * nb)
        wx = torch.clamp(xi - x0, 0, 1).reshape((-1,) + (1,) * nb)
        v = ((1 - wz) * (1 - wx) * b[z0, x0] + (1 - wz) * wx * b[z0, x1]
             + wz * (1 - wx) * b[z1, x0] + wz * wx * b[z1, x1])
        oob = ((zi < 0) | (zi > Tn - 1) | (xi < 0) | (xi > Nn - 1)).reshape(wz.shape)
        v = torch.where(oob, torch.zeros((), dtype=v.dtype, device=dev), v)
        return v.reshape(tuple(self.scan.shape) + (1,) + tuple(v.shape[1:])), bscan

    # ------------------------------------------------- eikonal beamformer
    def eikonal_tables(self, medium: Medium, cgrd: ScanCartesian, workers=None,
                       device=None):
        """One-way travel-time tables through a heterogeneous ``medium``
        (``UltrasoundSystem.bfEikonal``, ``src/UltrasoundSystem.m:4052-4332``):
        fast-marching maps per element on the isotropic 2-D or 3-D grid
        ``cgrd`` (``ops/eikonal.py``, host float64, ``workers`` threads),
        sampled at the scan pixels by cubic gridded interpolation. Returns
        ``(tau_rx (I, N), tau_tx (I, M))`` [s], float32 on ``device``
        (default: the CUDA device).

        Per sequence type, as the JAX package: FSA takes the per-element
        maps; FC, DV and VS one wavefront map per transmit from its focus
        (sign-flipped before the focus but for DV; a focus outside the grid
        seeds the grid's boundary with straight-ray times through the
        ambient ``c0``); PW and the others the Fermat first arrival
        ``min_n (tau_n - del(n, m))`` over each transmit's active elements.
        In a homogeneous medium these are the straight-ray tables of
        :meth:`das_delay_tables`.

        Example:
            import numpy as np
            import qups_tpu_torch as q
            xdc = q.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4),
                scan=q.ScanCartesian(x=np.linspace(-1e-3, 1e-3, 5),
                                     z=np.linspace(8e-3, 10e-3, 5)))
            h = 0.1e-3
            cgrd = q.ScanCartesian(x=np.arange(-2e-3, 2e-3 + h, h), y=[0.0],
                                   z=np.arange(0.0, 11e-3, h))
            tau_rx, tau_tx = us.eikonal_tables(q.Medium(c0=1540.0), cgrd, device="cpu")
            g_rx, _ = us.das_delay_tables(device="cpu")
            assert float((tau_rx - g_rx).abs().max()) * 1540.0 < 3 * h
        """
        device = default_device(device)
        assert isinstance(cgrd, ScanCartesian), "cgrd must be a ScanCartesian"
        vol = cgrd.ny > 1
        h = float(cgrd.dz)
        assert np.isclose(cgrd.dx, cgrd.dz, rtol=1e-3), \
            "eikonal requires isotropic grid spacing (UltrasoundSystem.m:4269)"
        if vol:
            assert np.isclose(cgrd.dy, cgrd.dz, rtol=1e-3), \
                "eikonal requires isotropic grid spacing"
            perm = [cgrd.order.index(c) for c in "ZXY"]
            cgrid = np.transpose(medium.props(cgrd, "c"), perm)  # (Nz, Nx, Ny)
        else:
            cgrid = _cmap_zx(cgrd, medium.props(cgrd, "c"))  # (Nz, Nx)

        def cells(p):  # element positions (3, E) -> nearest grid cells
            iz = np.clip(np.round((p[2] - cgrd.z[0]) / h).astype(int), 0, cgrd.nz - 1)
            ix = np.clip(np.round((p[0] - cgrd.x[0]) / h).astype(int), 0, cgrd.nx - 1)
            if vol:
                iy = np.clip(np.round((p[1] - cgrd.y[0]) / h).astype(int), 0,
                             cgrd.ny - 1)
                return np.stack([iz, ix, iy], -1)
            return np.stack([iz, ix], -1)

        maps_rx = msfm_multi(cgrid, h, cells(self.rx.positions()), workers=workers)

        # sample the maps at the scan pixels
        P = self.scan.positions().reshape(3, -1)
        zi = (P[2] - cgrd.z[0]) / h
        xi = (P[0] - cgrd.x[0]) / h
        if vol:
            yi = (P[1] - cgrd.y[0]) / h
            interp = lambda m: _grid_interp3(m, zi, xi, yi)  # noqa: E731
        else:
            interp = lambda m: _grid_interp2(m, zi, xi)  # noqa: E731
        tau_rx = np.stack([interp(m) for m in maps_rx], -1)  # (I, N)

        def tx_element_tables():  # (I, E): only the FSA and PW paths need these
            if self.tx is self.rx:
                maps_tx = maps_rx
            else:
                maps_tx = msfm_multi(cgrid, h, cells(self.tx.positions()),
                                     workers=workers)
            return np.stack([interp(m) for m in maps_tx], -1)

        st = self.seq.type
        if st == "FSA":
            tau_tx = tx_element_tables()
        elif st in ("FC", "DV", "VS"):
            pf = self.seq.focus_array  # (3, M)
            nvs = pf - self.tx.origin[:, None]
            nvs = nvs / np.maximum(np.linalg.norm(nvs, axis=0, keepdims=True), 1e-30)
            c0a = float(getattr(medium, "c0", self.seq.c0))
            bounds = [(cgrd.z[0], cgrd.z[-1]), (cgrd.x[0], cgrd.x[-1])] \
                + ([(cgrd.y[0], cgrd.y[-1])] if vol else [])
            cols = []
            for m in range(pf.shape[1]):
                p = pf[:, m]
                coord = (p[2], p[0], p[1]) if vol else (p[2], p[0])
                if all(lo + h <= v <= hi - h for v, (lo, hi) in zip(coord, bounds)):
                    srcs, t0s = cells(p.reshape(3, 1)), np.zeros(1)
                else:
                    srcs, t0s = _boundary_seeds(cgrd, cgrid.shape, h, p, c0a, vol)
                tm = interp(msfm(cgrid, h, srcs, src_t0=t0s))
                if st != "DV":
                    # two-sided: pixels behind the focal wavefront are negative
                    sgn = np.sign(((P - p[:, None]) * nvs[:, m:m + 1]).sum(0))
                    tm = tm * np.where(sgn == 0, 1.0, sgn)
                cols.append(tm)
            tau_tx = np.stack(cols, axis=-1)
        else:
            # PW (and custom): the Fermat first arrival over the active
            # aperture; element n fires at -seq.delays(n, m)
            tau_el = tx_element_tables()
            dels = self.seq.delays(self.tx)        # (E, M)
            apd = self.seq.apodization(self.tx)    # (E, M)
            tau_tx = np.empty((tau_el.shape[0], self.seq.num_pulse), tau_el.dtype)
            for m in range(self.seq.num_pulse):
                act = np.abs(apd[:, m]) > 0
                if not act.any():
                    act = np.ones(dels.shape[0], bool)
                tau_tx[:, m] = (tau_el[:, act] - dels[act, m][None, :]).min(1)
        return as_f32(tau_rx, device), as_f32(tau_tx, device)

    def bfEikonal(self, chd: ChannelData, medium: Medium,
                  cgrd: Optional[ScanCartesian] = None, apod=(), fmod: float = 0.0,
                  keep_tx: bool = False, keep_rx: bool = False, method: str = "auto",
                  workers=None, kernel: str = "auto", device=None) -> torch.Tensor:
        """Delay-and-sum with eikonal travel times through a heterogeneous
        ``medium`` (``UltrasoundSystem.bfEikonal``,
        ``src/UltrasoundSystem.m:4052-4332``) on 2-D or 3-D grids, any
        sequence type: :meth:`eikonal_tables` on ``cgrd`` (default: the scan
        widened to the array, at lambda / 4), then :meth:`bfDASLUT` on
        ``device`` (default: the CUDA device; kernel K2 on a CUDA tensor,
        its plain version with ``kernel='plain'`` or ``device="cpu"``).
        ``precision`` stays 'auto', as the JAX package passes none.

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
            cgrd = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 33),
                                   z=np.linspace(0.0, 26e-3, 105))
            b = us.bfEikonal(chd, q.Medium(c0=1540.0), cgrd, device="cpu")
            assert b.shape[:3] == us.scan.shape and bool(b.isfinite().all())
        """
        if cgrd is None:
            cgrd = self._eikonal_grid()
        tau_rx, tau_tx = self.eikonal_tables(medium, cgrd, workers=workers, device=device)
        return self.bfDASLUT(chd, tau_rx, tau_tx, apod=apod, fmod=fmod, keep_tx=keep_tx,
                             keep_rx=keep_rx, method=method, kernel=kernel, device=device)

    def _eikonal_grid(self) -> ScanCartesian:
        """The default medium grid of bfEikonal and kspaceFirstOrder: the scan
        extended to take in the transducer, at lambda / 4 with two cells of
        margin."""
        b = self.xdc.bounds()
        h = self.lmbda / 4
        P = self.scan.positions()
        x0 = min(b[0, 0], P[0].min()) - 2 * h
        x1 = max(b[0, 1], P[0].max()) + 2 * h
        z0 = min(b[2, 0], P[2].min()) - 2 * h
        z1 = max(b[2, 1], P[2].max()) + 2 * h
        return ScanCartesian(x=np.arange(x0, x1 + h, h), y=[0.0],
                             z=np.arange(z0, z1 + h, h))

    # ------------------------------------------------- full-wave simulation
    def kspaceFirstOrder(self, medium: Medium, cgrd: Optional[ScanCartesian] = None,
                         cfl: float = 0.3, npml: int = 10, tmax: Optional[float] = None,
                         el_proj: str = "nearest", el_sub: int = 0, record: str = "elements",
                         field_stride: int = 8, bg_subtract: bool = False, mesh=None,
                         device=None):
        """Full-wave simulation through a heterogeneous ``medium`` by the
        k-space PSTD stepper (``UltrasoundSystem.kspaceFirstOrder``,
        ``src/UltrasoundSystem.m:2458-3170``;
        :mod:`qups_tpu_torch.sim.fdtd`) on ``device`` (default: the CUDA
        device). Builds the grid (default: the scan and the array at lambda
        / 4) with a PML of ``npml`` cells (the maps padded by their edge), a
        CFL-limited time step that divides ``1 / us.fs``, the projection of
        the elements onto grid nodes for the sources and the sensors, and
        simulates every transmit; the received traces come back at ``us.fs``
        as ChannelData (T, N, M) on ``device``, ``t0`` per transmit.

        The medium's absorption (``alpha0``, ``alpha_power``) and B/A
        (``bona0``) are simulated where set. ``el_proj``: 'nearest' snaps
        each element to its closest node; 'linear' spreads ``el_sub``
        sub-element points (default ceil(width / h) + 1) over their
        surrounding nodes; 'karray' deposits and senses patch sub-points
        through truncated band-limited sinc stencils ('karray-direct' and
        'karray-depend' are aliases of it, as in the JAX package).

        ``record='field'`` also snapshots the full pressure every
        ``field_stride`` steps and returns ``(chd, fields)``, ``fields`` a
        float32 tensor (M, nsnap, *grid) on ``device``, the PML cropped.
        ``bg_subtract=True`` subtracts a second simulation through the
        ambient medium (``c0``, ``rho0`` and the ambient absorption and B/A
        everywhere), leaving the scattered field. The transmits run
        together, a leading batch of one stepper (in chunks of about 4 GiB
        of state and records), which gives each transmit the numbers of its
        own simulation. ``mesh``: a :class:`~qups_tpu_torch.parallel.Mesh`
        with a 'tx' axis: the transmits shard over it
        (:func:`~qups_tpu_torch.parallel.fdtd_sharded`, each shard's
        transmits one batch on its device), the traces on the mesh's first
        device; with ``record='field'`` the transmits run on that device as
        without a mesh.
        The stepper's spectral derivatives are k-Wave's (the whole grid's
        FFT with kappa(|k|); :mod:`qups_tpu_torch.sim.fdtd`), not the JAX
        package's, whose column-indexed kappa slows the wave in the grid's
        middle columns; the rest of the simulation is the JAX package's.

        Example:
            import numpy as np
            import qups_tpu_torch as q
            c0, fc = 1500.0, 2e6
            lam = c0 / fc
            xdc = q.TransducerArray(numel=8, pitch=lam / 2, fc=fc)
            us = q.UltrasoundSystem(
                tx=xdc, rx=xdc, seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=c0),
                scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                     z=np.linspace(1e-3, 4e-3, 8)), fs=4 * fc)
            cgrd = q.ScanCartesian(x=np.arange(-3e-3, 3e-3, lam / 4), y=[0.0],
                                   z=np.arange(-0.5e-3, 4.5e-3, lam / 4))
            chd = us.kspaceFirstOrder(q.Medium(c0=c0), cgrd, tmax=2e-6, device="cpu")
            assert (chd.N, chd.M) == (8, 1) and bool(chd.data.isfinite().all())
        """
        dev = _mesh_device(mesh) if mesh is not None else default_device(device)
        if el_proj in ("karray-direct", "karray-depend"):
            el_proj = "karray"
        cgrd = cgrd if cgrd is not None else self._eikonal_grid()
        if not isinstance(cgrd, ScanCartesian):
            raise TypeError("cgrd must be a ScanCartesian")
        vol = cgrd.ny > 1
        if not (np.isclose(cgrd.dx, cgrd.dz, rtol=1e-3)
                and (not vol or np.isclose(cgrd.dy, cgrd.dz, rtol=1e-3))):
            raise ValueError("grid must be isotropic")
        if record not in ("elements", "field"):
            raise ValueError(f"unknown record mode {record!r}")
        h = float(cgrd.dz)

        # property maps (Z, X[, Y]) + PML padding (edge replicate)
        if vol:
            perm = [cgrd.order.index(c) for c in "ZXY"]
            to_grid = lambda m: np.transpose(m, perm)  # noqa: E731
        else:
            to_grid = lambda m: _cmap_zx(cgrd, m)  # noqa: E731
        props = medium.props(cgrd, ("c", "rho", "alpha", "bona"))
        cmap, rmap, amap, bmap = (np.pad(to_grid(props[k]), npml, mode="edge")
                                  for k in ("c", "rho", "alpha", "bona"))
        # NaN ambient values mean the physics is off (Medium defaults)
        amap = None if np.isnan(amap).all() else np.nan_to_num(amap)
        bmap = None if np.isnan(bmap).all() else np.nan_to_num(bmap)
        cmax = float(cmap.max())
        want_field = record == "field"
        fstride = int(field_stride) if want_field else 0

        # CFL-limited dt aligned to us.fs (integer divisor)
        fs = float(self.fs)
        k = max(1, int(np.ceil(1.0 / (fs * cfl * h / cmax))))
        dt = 1.0 / (fs * k)

        shp = cmap.shape
        tx_proj = _element_nodes(self.tx, el_proj, el_sub, cgrd, h, npml, shp)
        rx_proj = _element_nodes(self.rx, el_proj, el_sub, cgrd, h, npml, shp)
        rec_rows = tuple(sorted({int(r) for nodes_, _ in rx_proj for r in nodes_[:, 0]}))

        # transmit waveform at the simulation's rate; simulation length
        wv = self.tx.impulse.conv(self.seq.pulse, 1.0 / dt)
        delays = self.seq.delays(self.tx)       # (N_el, M)
        apod = self.seq.apodization(self.tx)    # (N_el, M)
        M = self.seq.num_pulse
        if tmax is None:
            diag = np.hypot(cgrd.x[-1] - cgrd.x[0], cgrd.z[-1] - cgrd.z[0])
            tmax = 2.2 * diag / float(cmap.min()) + wv.duration
        steps = int(np.ceil(tmax / dt))

        def tx_sources(v):
            """One transmit's source nodes and signals, before merging."""
            act = np.where(np.abs(apod[:, v]) > 0)[0]
            maxdel = float(delays[act, v].max()) if act.size else 0.0
            t0_sim = -maxdel + wv.t0
            s = np.arange(steps) * dt
            nodes, sigs = [], []
            for n in act:
                sn = apod[n, v] * np.real(np.asarray(wv.sample(s + t0_sim + delays[n, v])))
                nodes_, w_ = tx_proj[n]
                nodes.append(nodes_)
                sigs.append(sn[:, None] * w_[None, :])
            return (np.concatenate(nodes, 0), np.concatenate(sigs, 1).astype(np.float32),
                    t0_sim)

        # one node set for all transmits: each transmit's signal summed per
        # node in the order of its own list (a node it does not drive gets 0)
        per = [tx_sources(v) for v in range(M)]
        uniq, inv = np.unique(np.concatenate([p_[0] for p_ in per], 0), axis=0,
                              return_inverse=True)
        inv = inv.reshape(-1)
        sig = np.zeros((M, steps, uniq.shape[0]), np.float32)
        o = 0
        for v, (nodes_v, sig_v, _) in enumerate(per):
            np.add.at(sig[v].T, inv[o:o + len(nodes_v)], sig_v.T)
            o += len(nodes_v)
        t0 = np.array([p_[2] for p_ in per])
        del per

        # the sensors: one (recorded nodes, N) weight matrix
        rest = int(np.prod(shp[1:]))
        row_of = {r: i for i, r in enumerate(rec_rows)}
        S = np.zeros((len(rec_rows) * rest, len(rx_proj)))
        for n, (nodes_, w_) in enumerate(rx_proj):
            off = np.array([row_of[int(r)] for r in nodes_[:, 0]]) * rest
            pos = off + (nodes_[:, 1] * shp[2] + nodes_[:, 2] if vol else nodes_[:, 1])
            np.add.at(S[:, n], pos, w_)
        S = as_f32(S, dev)

        sim = kspace_sim_3d if vol else kspace_sim_2d
        src = (uniq.T,) if vol else (uniq[:, 0], uniq[:, 1])
        kw = dict(steps=steps, dt=dt, dx=h, c_ref=cmax, record_rows=rec_rows,
                  alpha_power=float(medium.alpha_power), field_stride=fstride, device=dev)
        bg = None
        if bg_subtract:
            # iso-impedance ambient background: same sources, dt and steps
            bg = (np.full_like(cmap, float(medium.c0)), np.full_like(rmap, float(medium.rho0)),
                  None if amap is None else np.full_like(cmap, float(np.nan_to_num(medium.alpha0))),
                  None if bmap is None else np.full_like(cmap, float(np.nan_to_num(medium.bona0))))
        if mesh is not None and not want_field:
            # the transmits shard over the mesh's 'tx' axis, one batch a shard
            kwm = dict(steps=steps, dt=dt, dx=h, c_ref=cmax, record_rows=rec_rows,
                       alpha_power=float(medium.alpha_power), axis="tx")
            rec = fdtd_sharded(mesh, cmap, rmap, uniq.T, sig, alpha0=amap, bona=bmap, **kwm)
            if bg is not None:
                rec = rec - fdtd_sharded(mesh, bg[0], bg[1], uniq.T, sig, alpha0=bg[2],
                                         bona=bg[3], **kwm)
            tr = (rec.reshape(M, steps, -1) @ S)[:, ::k]  # (M, T, N)
            return ChannelData(data=tr.permute(1, 2, 0), fs=fs, t0=t0)
        nsnap = -(-steps // fstride) if fstride else 0
        chunk = batch_chunk(steps, S.shape[0], uniq.shape[0], shp, nsnap)
        traces, fields = [], []
        crop = (slice(None), slice(None)) + tuple(slice(npml, n - npml) for n in shp)
        for v0 in range(0, M, chunk):
            sg = torch.as_tensor(np.ascontiguousarray(
                sig[v0:v0 + chunk].transpose(1, 0, 2)), device=dev)  # (steps, B, Q)
            out = sim(cmap, rmap, *src, sg, alpha0=amap, bona=bmap, **kw)
            rec, fld = out if want_field else (out, None)
            if bg is not None:
                out = sim(bg[0], bg[1], *src, sg, alpha0=bg[2], bona=bg[3], **kw)
                rec = rec - (out[0] if want_field else out)
                fld = fld - out[1] if want_field else None
            tr = rec.reshape(steps, rec.shape[1], -1) @ S  # (steps, B, N)
            traces.append(tr[::k])
            if want_field:
                fields.append(fld[crop].transpose(0, 1))
        chd = ChannelData(data=torch.cat(traces, 1).permute(0, 2, 1), fs=fs, t0=t0)  # (T, N, M)
        return (chd, torch.cat(fields)) if want_field else chd


def self_c0(us: UltrasoundSystem) -> float:
    """The sound speed of ``us``'s sequence as a float, the default c0 of
    ``bfAdjoint``: ``qups_tpu.system.self_c0``. Host arithmetic; nothing on
    a device."""
    return float(us.seq.c0)


def _element_nodes(xdc: Transducer, el_proj: str, el_sub: int, cgrd: ScanCartesian,
                   h: float, npml: int, shp) -> list:
    """Per element of ``xdc``, the grid nodes ``(K, nd)`` and weights
    ``(K,)`` of its projection (``Transducer.elem2grid``,
    ``src/Transducer.m:578``) onto the PML-padded (Z, X[, Y]) grid of
    shape ``shp``: 'nearest' the closest node; 'linear' the multilinear
    deposit of ``el_sub`` sub-element points (default ceil(width / h) + 1);
    'karray' the kWaveArray-class off-grid projection
    (``src/Transducer.m:734``): ceil(width / h) + 2 sub-points, each through
    a separable sinc stencil of half-width 3 (the band-limited interpolant
    of a PSTD grid, truncated; > 97 % of its mass)."""
    vol = len(shp) == 3
    nd = len(shp)
    org = np.array([cgrd.z[0], cgrd.x[0]] + ([cgrd.y[0]] if vol else []))
    hi = np.array(shp) - 1
    p_el = xdc.positions()
    out = []
    for n in range(p_el.shape[1]):
        if el_proj == "nearest":
            pts = p_el[:, n:n + 1]
        elif el_proj in ("linear", "karray"):
            K = el_sub or (int(np.ceil(xdc.width / h)) + (2 if el_proj == "karray" else 1))
            pts = xdc.bary_centers((K, 1))[:, n, :]
        else:
            raise ValueError(f"unknown el_proj {el_proj!r} (one of 'nearest', 'linear', "
                             "'karray')")
        q = np.stack([pts[2], pts[0]] + ([pts[1]] if vol else []))
        fc = (q - org[:, None]).T / h + npml  # (K, nd) fractional node coordinates
        K = fc.shape[0]
        if el_proj == "nearest":
            out.append((np.clip(np.round(fc).astype(int), 0, hi), np.ones(1)))
            continue
        nodes_l, w_l = [], []
        if el_proj == "karray":
            HW = 3
            f0 = np.round(fc).astype(int)
            for corner in np.ndindex(*([2 * HW + 1] * nd)):
                cs = np.asarray(corner) - HW
                nodes_l.append(np.clip(f0 + cs, 0, hi))
                w_l.append(np.prod(np.sinc(fc - (f0 + cs)), axis=1) / K)
        else:
            f0 = np.floor(fc).astype(int)
            fr = fc - f0
            for corner in np.ndindex(*([2] * nd)):
                cs = np.asarray(corner)
                nodes_l.append(np.clip(f0 + cs, 0, hi))
                w_l.append(np.prod(np.where(cs == 1, fr, 1 - fr), axis=1) / K)
        out.append((np.concatenate(nodes_l, 0), np.concatenate(w_l, 0)))
    return out


def _grid_interp2(vals, zi, xi, method: str = "cubic"):
    """Gridded interpolation of ``vals (Nz, Nx)`` at fractional indices,
    cubic by default, as the reference's ``griddedInterpolant(grd, tau,
    'cubic')`` (``UltrasoundSystem.m:4318``)."""
    return gridded_interp(vals, [zi, xi], method=method)


def _cmap_zx(cgrd: ScanCartesian, cmap: np.ndarray) -> np.ndarray:
    """A property map on ``cgrd`` in (Z, X) layout."""
    m2 = np.squeeze(cmap, axis=cgrd.order.index("Y"))
    rem = [c for c in cgrd.order if c != "Y"]
    return m2 if rem == ["Z", "X"] else m2.T


def _grid_interp3(vals, zi, xi, yi, method: str = "cubic"):
    """Gridded interpolation of ``vals (Nz, Nx, Ny)`` at fractional
    indices, cubic by default (see :func:`_grid_interp2`)."""
    return gridded_interp(vals, [zi, xi, yi], method=method)


def _boundary_seeds(cgrd: ScanCartesian, shape, h: float, p, c0: float, vol: bool):
    """The wavefront sources of a virtual apex ``p`` outside the grid:
    every boundary cell of the (Z, X[, Y]) grid ``shape``, each at its
    straight-ray time from ``p`` through the ambient ``c0``. Returns
    ``(cells (S, ndim), times (S,))``."""
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"),
                   -1).reshape(-1, len(shape))
    on_edge = np.zeros(len(idx), bool)
    for d, s in enumerate(shape):
        on_edge |= (idx[:, d] == 0) | (idx[:, d] == s - 1)
    srcs = idx[on_edge]
    org = np.array([cgrd.z[0], cgrd.x[0]] + ([cgrd.y[0]] if vol else []))
    apx = np.array([p[2], p[0]] + ([p[1]] if vol else []))
    return srcs, np.linalg.norm(org[None, :] + srcs * h - apx[None], axis=1) / c0


# kspaceFirstOrder runs its transmits in batches of about this many bytes
# of state, sources and records
# refocus's decode operators, ~2 GiB each at T 4096, M = V = 256
_REFOCUS_OP_CACHE: dict = {}
_REFOCUS_OP_CACHE_MAX_BYTES = int(os.environ.get("QUPS_REFOCUS_CACHE_BYTES",
                                                 str(3 * 1024**3)))
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
