from .interp import fft_upsample, interp1, interpd, interpf, wsinterpd, wsinterpd2
from .coherence import cohfac, dmas, pcf, pwznxcorr, slsc
from .conv import convd, conv_lag0, conv_len, xcorr
from .das import das, das_lut, delay_tables, tx_distance
from .das_cuda import (Fused, das_lut_plan, das_lut_sum, das_lut_sum_plain, das_lut_tiled,
                       das_sum, das_sum_plain, das_tiled, fused_weights, prep_lut_sharded,
                       prep_sharded)
from .fdbf import (bf_adjoint, focus_tx_freq, geom_delays, refocus, refocus_apply, refocus_op,
                   select_fbins, stolt_migration)
from .eikonal import msfm, msfm_multi
from .fdbf_cuda import bf_adjoint_cuda, bf_adjoint_tiled
from .greens import greens_dense, greens_splat
from .greens_cuda import greens_tiled, splat, splat_plain
from .greens_freq import greens_freq
from .greens_freq_cuda import (freq_gemm, freq_gemm_cuda, freq_gemm_plain,
                               simus_spectrum_cuda)
from .rays import (global_average_c, ray_paths, ray_paths_device, wbilerp, wbilerp_dense,
                   xiaolinwu_line)
from .simus import simus_fsa

__all__ = [
    "fft_upsample", "interp1", "interpd", "interpf", "wsinterpd", "wsinterpd2",
    "cohfac", "dmas", "pcf", "pwznxcorr", "slsc",
    "convd", "conv_lag0", "conv_len", "xcorr", "das", "das_lut", "delay_tables", "tx_distance", "Fused",
    "das_sum", "das_sum_plain", "das_lut_sum", "das_lut_sum_plain", "fused_weights",
    "das_tiled", "das_lut_tiled", "das_lut_plan", "prep_sharded", "prep_lut_sharded",
    "bf_adjoint", "focus_tx_freq", "geom_delays", "select_fbins",
    "refocus", "refocus_op", "refocus_apply", "stolt_migration",
    "bf_adjoint_cuda", "bf_adjoint_tiled", "greens_dense", "greens_splat", "greens_freq",
    "freq_gemm", "freq_gemm_plain", "freq_gemm_cuda", "simus_spectrum_cuda", "greens_tiled", "splat", "splat_plain",
    "simus_fsa", "msfm", "msfm_multi",
    "wbilerp", "wbilerp_dense", "xiaolinwu_line", "ray_paths", "ray_paths_device",
    "global_average_c",
]
