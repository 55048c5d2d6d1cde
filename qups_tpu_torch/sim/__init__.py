from .fdtd import db2neper, kspace_sim_1d, kspace_sim_2d, kspace_sim_3d

__all__ = ["db2neper", "kspace_sim_1d", "kspace_sim_2d", "kspace_sim_3d"]
