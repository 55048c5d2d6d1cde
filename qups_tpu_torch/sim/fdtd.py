"""k-space pseudospectral full-wave simulation, the port of
:mod:`qups_tpu.sim.fdtd`.

A first-order coupled acoustic PSTD stepper on a staggered grid with the
k-space correction ``kappa = sinc(c_ref |k| dt / 2)`` and a split-field PML
(the JAX package's stand-in for the reference's k-Wave interop,
``UltrasoundSystem.kspaceFirstOrder``, ``src/UltrasoundSystem.m:2458-3170``):

    du/dt   = -(1/rho0) grad(p)        (staggered spatial shifts)
    drho/dt = -rho0 div(u) + source
    p       = c^2 (rho + B/2A rho^2/rho0 + absorption)

with the optional power-law absorption and dispersion (fractional
Laplacian, two more FFT pairs a step) and B/A nonlinearity.

The JAX package's ``lax.fori_loop`` is a Python loop over the steps here,
whose body never waits on the device: the maps, the spectral operators,
the PML profiles, the sources and the recorded rows stay on ``device``
(default: the CUDA device). The grid arithmetic (dt, kappa, the k-grids, the
absorption's operators) is float64 on the host, as in the JAX package; only
the resulting maps go to the device, as float32.

Each spectral derivative is ``real(ifftn(op * fftn(f)))`` over the whole
grid with ``op = 1j k_d kappa(|k|) e^{+-i k_d dx / 2}``, the k-space
operator of k-Wave (the gradient of the pressure shares one forward
transform), by ``rfftn`` / ``irfftn``: ``op`` is Hermitian, so the half
spectrum gives the same real field at half the work. The JAX package's 2-D
and 3-D steppers transform along the derivative's axis only and index
kappa's other axes by the grid's spatial columns: the correction then
depends on the column, and a plane wave slows down the middle columns of a
grid (1518 m/s for 1540 in a 16-column grid,
``tests/test_torch_fdtd.py::test_plane_wave_speed``), which puts the deep
targets of a beamformed full-wave image millimetres off. The port does not carry that
over; its 1-D stepper equals the JAX package's (one axis, no columns), and
so do its 2-D and 3-D steppers where kappa is 1 (``c_ref = 0``). The
steppers take an optional leading batch of source signals (one simulation
each, through the same media), which ``UltrasoundSystem.kspaceFirstOrder``
uses to run its transmits in one loop.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.backend import as_f32, default_device


def _pml_profile(n: int, npml: int, alpha_max: float, dt: float) -> np.ndarray:
    """Exponential PML absorption profile along one axis (length n)."""
    x = np.zeros(n)
    if npml > 0:
        ramp = (np.arange(1, npml + 1) / npml) ** 4
        x[:npml] = ramp[::-1]
        x[-npml:] = ramp
    return np.exp(-alpha_max * x * dt / 2)


def db2neper(alpha_db, y: float):
    """dB/(MHz^y cm) -> Np (rad/s)^-y / m (the k-Wave unit conversion)."""
    return 100.0 * np.asarray(alpha_db) * (1e-6 / (2 * np.pi)) ** y \
        / (20.0 * np.log10(np.e))


def _absorb_terms(alpha0: torch.Tensor, alpha_power: float, c: torch.Tensor,
                  Knp: np.ndarray):
    """Fractional-Laplacian absorption operators ``(tau, eta, nabla1,
    nabla2)``: tau and eta in real space on the device of ``c`` (float32
    arithmetic, as the JAX package's traced maps), the nablas in k-space
    from the host's float64 ``|k|`` with the k = 0 (and any singular)
    component zeroed."""
    y = float(alpha_power)
    a_np = 100.0 * alpha0 * float(np.float32((1e-6 / (2 * np.pi)) ** y
                                             / (20.0 * np.log10(np.e))))
    tau = -2.0 * a_np * c ** (y - 1.0)
    eta = 2.0 * a_np * c ** y * float(np.float32(np.tan(np.pi * y / 2.0)))
    with np.errstate(divide="ignore"):
        nab1 = Knp ** (y - 2.0)
        nab2 = Knp ** (y - 1.0)
    nab1[~np.isfinite(nab1)] = 0.0
    nab2[~np.isfinite(nab2)] = 0.0
    return tau, eta, as_f32(nab1, c.device), as_f32(nab2, c.device)


BATCH_BYTES = 4 * 1024**3  # about what one batched stepper call holds


def batch_chunk(steps: int, n_rec: int, Q: int, shape, nsnap: int = 0) -> int:
    """How many simulations one batched stepper call takes within
    ``BATCH_BYTES``: each holds its records (``steps`` x ``n_rec`` nodes),
    its source signals (``steps`` x ``Q``), ``nsnap`` snapshots and about
    12 grids of state (``shape``)."""
    per = 4 * (steps * (n_rec + Q) + (nsnap + 12) * int(np.prod(shape)))
    return max(1, int(BATCH_BYTES // per))


def _half(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The rfft half of a full-spectrum operator along ``dim`` (the bins
    0 .. n // 2 of fftfreq's order: an even axis keeps its -Nyquist bin)."""
    return a.narrow(dim, 0, a.shape[dim] // 2 + 1)


def _simulate(c, rho, src_idx, src_sig, *, steps: int, dt: float, dx: float, c_ref: float,
              record_rows, alpha0, alpha_power: float, bona, field_stride: int, npml: int,
              device):
    """The stepper of :func:`kspace_sim_1d`, :func:`kspace_sim_2d` and
    :func:`kspace_sim_3d` on an nd-D grid: ``src_idx (nd, Q)`` node
    indices, ``src_sig (steps, Q)`` or ``(steps, B, Q)``."""
    dev = default_device(device)
    c, rho = as_f32(c, dev), as_f32(rho, dev)
    shape = tuple(c.shape)
    nd = len(shape)
    sdims = tuple(range(1, nd + 1))  # spatial dims of the (B, *grid) state
    ks = [np.fft.fftfreq(n, dx) * 2 * np.pi for n in shape]
    kb = [k.reshape([-1 if a == d else 1 for a in range(nd)]) for d, k in enumerate(ks)]
    Knp = np.sqrt(sum(k ** 2 for k in kb))
    kappa = as_f32(np.sinc(c_ref * Knp * dt / 2 / np.pi), dev)
    alpha = 2.0 * c_ref / dx  # strong absorption
    ops_f, ops_b, pml = [], [], []
    for d in range(nd):
        K = as_f32(kb[d], dev)
        a = K * kappa  # 1j K kappa e^{+-i K dx / 2}, multiplied in the JAX package's order
        th = K * dx / 2
        cs, sn = torch.cos(th), torch.sin(th)
        ops_f.append(_half(torch.complex(-a * sn, a * cs), nd - 1))
        ops_b.append(_half(torch.complex(a * sn, a * cs), nd - 1))
        pml.append(as_f32(_pml_profile(shape[d], npml, alpha, dt).reshape(kb[d].shape), dev))

    rho0 = rho
    c2 = c * c
    dt_rho = dt / rho0
    dt_rho0 = dt * rho0
    absorbing = alpha0 is not None
    if absorbing:
        tau, eta, nab1, nab2 = _absorb_terms(as_f32(alpha0, dev), alpha_power, c, Knp)
        nab1, nab2 = _half(nab1, nd - 1), _half(nab2, nd - 1)
    nonlin = bona is not None
    if nonlin:
        bq = as_f32(bona, dev) / (2.0 * rho0)

    def spectrum(f):
        return torch.fft.rfftn(f, dim=sdims)

    def deriv(F, op):  # real(ifftn(op * fftn(f))) from F = spectrum(f)
        return torch.fft.irfftn(op * F, s=shape, dim=sdims)

    def pressure(rho_t, divu):
        pr = rho_t
        if nonlin:
            pr = pr + bq * rho_t * rho_t
        if absorbing:
            Fd = torch.fft.rfftn(rho0 * divu, dim=sdims)
            Fr = torch.fft.rfftn(rho_t, dim=sdims)
            pr = pr + tau * torch.fft.irfftn(nab1 * Fd, s=shape, dim=sdims) \
                + eta * torch.fft.irfftn(nab2 * Fr, s=shape, dim=sdims)
        return c2 * pr

    sig = as_f32(src_sig, dev)
    batched = sig.ndim == 3
    sig = sig if batched else sig[:, None]
    B = sig.shape[1]
    src = np.asarray(src_idx, np.int64).reshape(nd, -1)
    if src.shape[1] and ((src < 0).any() or (src >= np.array(shape)[:, None]).any()):
        raise ValueError("source node indices fall outside the grid")
    flat = torch.as_tensor(np.ravel_multi_index(tuple(src), shape), device=dev)
    # the injection, split over the nd density components, for every step
    inj = sig / (nd * c2.reshape(-1)[flat])  # (steps, B, Q)
    rows = torch.as_tensor(np.asarray(record_rows, np.int64), device=dev)
    nsnap = -(-steps // field_stride) if field_stride else 0

    z = torch.zeros((B,) + shape, dtype=torch.float32, device=dev)
    u = [z.clone() for _ in range(nd)]
    r = [z.clone() for _ in range(nd)]
    p = z
    rec = torch.zeros((steps, B, rows.numel()) + shape[1:], dtype=torch.float32, device=dev)
    fld = torch.zeros((nsnap, B) + shape, dtype=torch.float32, device=dev)
    for i in range(steps):
        # velocity (staggered forward shift), then density (backward), per axis
        P = spectrum(p)
        for d in range(nd):
            u[d] = pml[d] * (pml[d] * u[d] - dt_rho * deriv(P, ops_f[d]))
        du = [deriv(spectrum(u[d]), ops_b[d]) for d in range(nd)]
        for d in range(nd):
            r[d] = pml[d] * (pml[d] * r[d] - dt_rho0 * du[d])
            # additive pressure source, injected as density (p = c^2 rho)
            r[d].view(B, -1).index_add_(1, flat, inj[i])
        rho_t, divu = r[0], du[0]
        for d in range(1, nd):
            rho_t, divu = rho_t + r[d], divu + du[d]
        p = pressure(rho_t, divu)
        rec[i] = p.index_select(1, rows)
        if field_stride and i % field_stride == 0:
            fld[i // field_stride] = p
    if not batched:
        rec, fld = rec[:, 0], fld[:, 0]
    return (rec, fld) if field_stride else rec


def kspace_sim_2d(c, rho, src_rows, src_cols, src_sig, *, steps: int, dt: float, dx: float,
                  c_ref: float, record_rows: Sequence[int], alpha0=None,
                  alpha_power: float = 1.5, bona=None, field_stride: int = 0, device=None):
    """2-D k-space PSTD simulation on ``device`` (default: the CUDA device).

    Args:
      c, rho: sound-speed [m/s] and density [kg/m^3] maps (Nz, Nx), PML
        region included.
      src_rows, src_cols: (Q,) source node indices.
      src_sig: (steps, Q) source waveform (added to pressure) per node, or
        (steps, B, Q): B simulations through the same maps in one loop.
      steps, dt, dx, c_ref: the number of steps, the time step [s], the
        isotropic grid spacing [m] and the k-space correction's speed.
      record_rows: grid rows whose pressure is recorded every step.
      alpha0: optional power-law absorption map [dB/(MHz^y cm)], with the
        exponent ``alpha_power``; bona: optional B/A nonlinearity map.
      field_stride: if > 0, also snapshot the full pressure field every
        ``field_stride`` steps.

    Returns: recorded pressure (steps, [B,] len(record_rows), Nx) float32 on
    ``device``; with ``field_stride`` > 0, ``(recorded, field)`` with field
    (ceil(steps / stride), [B,] Nz, Nx).

    Example:
        import numpy as np
        from qups_tpu_torch.sim.fdtd import kspace_sim_2d
        c0, h, n, steps = 1500.0, 0.2e-3, 64, 120
        dt = 0.3 * h / c0
        t = np.arange(steps) * dt
        sig = (np.exp(-((t - 0.8e-6) * 4e6) ** 2)
               * np.sin(2 * np.pi * 2e6 * t))[:, None].astype(np.float32)
        rec = kspace_sim_2d(np.full((n, n), c0), np.full((n, n), 1e3), [16], [32], sig,
                            steps=steps, dt=dt, dx=h, c_ref=c0, record_rows=(40,),
                            device="cpu")
        assert rec.shape == (steps, 1, n)
        t_pk = t[int(rec[:, 0, 32].abs().argmax())]
        assert abs(t_pk - (24 * h / c0 + 0.8e-6)) < 0.5e-6
    """
    idx = np.stack([np.asarray(src_rows).reshape(-1), np.asarray(src_cols).reshape(-1)])
    return _simulate(c, rho, idx, src_sig, steps=steps, dt=dt, dx=dx, c_ref=c_ref,
                     record_rows=record_rows, alpha0=alpha0, alpha_power=alpha_power,
                     bona=bona, field_stride=field_stride, npml=10, device=device)


def kspace_sim_3d(c, rho, src_idx, src_sig, *, steps: int, dt: float, dx: float,
                  c_ref: float, record_rows: Sequence[int], alpha0=None,
                  alpha_power: float = 1.5, bona=None, field_stride: int = 0, device=None):
    """3-D k-space PSTD simulation (the volumetric ``kspaceFirstOrder3D``)
    on ``device`` (default: the CUDA device): maps (Nz, Nx, Ny),
    ``src_idx (3, Q)`` node indices (z, x, y), ``src_sig (steps, [B,] Q)``,
    ``record_rows`` the z-planes recorded. Otherwise as
    :func:`kspace_sim_2d` (a PML of 8 cells). Returns (steps, [B,] R, Nx,
    Ny); with ``field_stride`` > 0, ``(recorded, field)`` with field
    (ceil(steps / stride), [B,] Nz, Nx, Ny)."""
    return _simulate(c, rho, src_idx, src_sig, steps=steps, dt=dt, dx=dx, c_ref=c_ref,
                     record_rows=record_rows, alpha0=alpha0, alpha_power=alpha_power,
                     bona=bona, field_stride=field_stride, npml=8, device=device)


def kspace_sim_1d(c, rho, src_idx, src_sig, *, steps: int, dt: float, dx: float,
                  c_ref: float, record_rows: Sequence[int], alpha0=None,
                  alpha_power: float = 1.5, bona=None, field_stride: int = 0, device=None):
    """1-D k-space PSTD simulation (``kspaceFirstOrder1D``: plane-wave and
    through-transmission columns) on ``device`` (default: the CUDA
    device): maps (Nz,), ``src_idx (Q,)``, ``src_sig (steps, [B,] Q)``,
    ``record_rows`` the cells recorded. Returns (steps, [B,] R); with
    ``field_stride`` > 0, ``(recorded, field)`` with field
    (ceil(steps / stride), [B,] Nz).

    Example:
        import numpy as np
        from qups_tpu_torch.sim.fdtd import kspace_sim_1d
        c0, h = 1500.0, 0.2e-3
        N, steps = 256, 450
        dt = 0.3 * h / c0
        t = np.arange(steps) * dt
        sig = (np.exp(-((t - 1e-6) * 2e6 * 2) ** 2)
               * np.sin(2 * np.pi * 2e6 * t))[:, None].astype(np.float32)
        rec = kspace_sim_1d(np.full(N, c0), np.full(N, 1000.0), np.array([30]), sig,
                            steps=steps, dt=dt, dx=h, c_ref=c0, record_rows=(140,),
                            device="cpu")
        t_pk = t[int(rec[:, 0].abs().argmax())]
        assert abs(t_pk - (110 * h / c0 + 1e-6)) < 4 * dt
    """
    return _simulate(c, rho, np.asarray(src_idx).reshape(1, -1), src_sig, steps=steps,
                     dt=dt, dx=dx, c_ref=c_ref, record_rows=record_rows, alpha0=alpha0,
                     alpha_power=alpha_power, bona=bona, field_stride=field_stride,
                     npml=10, device=device)
