"""Several devices from one process: :class:`Mesh`, :func:`make_mesh` and
the sharded pipelines (:mod:`qups_tpu_torch.parallel.mesh`)."""
from .mesh import (Mesh, make_mesh, das_sharded, das_sharded_pallas,
                   das_sharded_pallas_plan,
                   das_lut_sharded_pallas, das_lut_sharded_pallas_plan,
                   greens_sharded,
                   greens_freq_sharded, bf_adjoint_sharded, fdtd_sharded,
                   refocus_op_sharded, refocus_sharded,
                   focus_tx_freq_sharded, migration_sharded)

__all__ = ["Mesh", "make_mesh", "das_sharded", "das_sharded_pallas",
           "das_sharded_pallas_plan",
           "das_lut_sharded_pallas", "das_lut_sharded_pallas_plan",
           "greens_sharded",
           "greens_freq_sharded", "bf_adjoint_sharded", "fdtd_sharded",
           "refocus_op_sharded", "refocus_sharded", "focus_tx_freq_sharded",
           "migration_sharded"]
