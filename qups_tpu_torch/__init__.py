"""qups_tpu_torch: the PyTorch + CUDA port of qups_tpu.

The JAX package ``qups_tpu`` is the reference; this package mirrors its
module layout (``core/``, ``ops/``, ``utils/``, ``system.py``) and imports
``torch`` and numpy, never JAX. Plain tensor code is PyTorch; the TPU
kernels on the ported path are hand-written CUDA for Hopper under
``csrc/``, built on first use. Slice 1 is sim→image: build an
:class:`UltrasoundSystem`, simulate with ``us.greens(scat)``, beamform with
``us.DAS(chd)`` (kernel K1 on a CUDA tensor). Slice 2 is the plane-wave
imaging demo: ``greens`` synthesizes any sequence through ``us.focusTx``,
and ``us.bfDAS`` / ``us.bfDASLUT`` (kernel K2) and ``us.bfAdjoint``
(kernel K4) beamform it. IQ and frame ensembles: ``ChannelData``'s DSP
(``join``, ``hilbert``, ``downmix``, ``resample``, ...) makes baseband
frames, which ``us.DAS(iq, fmod=fc)`` and ``us.bfDAS`` beamform on K1(b)
and K2(b). Heterogeneous media: a :class:`Medium`'s sound-speed map
gives ``us.bfEikonal`` its delay tables (fast marching on the host, then
K2). REFoCUS and Stolt migration: ``us.refocus`` decodes synthesized
transmits back to FSA, ``us.bfMigration`` images plane waves by f-k
migration. Ray path integrals: ``ops.rays``. Full-wave simulation:
``us.kspaceFirstOrder`` through a :class:`Medium` by the k-space PSTD
steppers of ``sim.fdtd``. The entry points run on the card unless given
``device=``.
"""
from .core import (
    Waveform, Transducer, TransducerArray, TransducerConvex, TransducerMatrix,
    TransducerGeneric, Sequence, SequenceRadial, SequenceGeneric, Scan,
    ScanCartesian, ScanPolar, ScanSpherical, ScanGeneric, Scatterers,
    ChannelData, Medium,
)
from .system import UltrasoundSystem
from .ops.das_cuda import Fused
from .convert import from_reference
from . import ops
from . import sim
from . import utils

__version__ = "0.1.0"
