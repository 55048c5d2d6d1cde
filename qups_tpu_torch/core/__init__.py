from .waveform import Waveform
from .xdc import (Transducer, TransducerArray, TransducerConvex,
                  TransducerMatrix, TransducerGeneric)
from .seq import Sequence, SequenceRadial, SequenceGeneric
from .scan import (Scan, ScanCartesian, ScanPolar, ScanSpherical, ScanGeneric)
from .scat import Scatterers
from .channel_data import ChannelData
from .medium import Medium

__all__ = [
    "Waveform", "Transducer", "TransducerArray", "TransducerConvex",
    "TransducerMatrix", "TransducerGeneric", "Sequence", "SequenceRadial",
    "SequenceGeneric", "Scan", "ScanCartesian", "ScanPolar", "ScanSpherical",
    "ScanGeneric", "Scatterers", "ChannelData", "Medium",
]
