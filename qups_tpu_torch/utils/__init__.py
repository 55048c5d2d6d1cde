from .backend import as_f32, is_cuda, to_host
from .maths import (box_rbounds, cosd, db2pow, deg2rad, gridded_interp, isalmostn,
                    mod2db, nan2zero, next_pow2, pow2db, rad2deg, rsqrt, sind, vecnorm)
from .profiling import Timer, annotate, trace

__all__ = ["as_f32", "is_cuda", "to_host", "box_rbounds", "cosd", "db2pow", "deg2rad",
           "gridded_interp", "isalmostn", "mod2db", "nan2zero", "next_pow2", "pow2db",
           "rad2deg", "rsqrt", "sind", "vecnorm", "trace", "Timer", "annotate"]
