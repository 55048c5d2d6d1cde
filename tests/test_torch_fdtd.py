"""The port's k-space full-wave simulator on the CPU: the steppers (1-D,
2-D and 3-D; even and odd grids; lossless, absorbing, nonlinear and both;
field snapshots) and kspaceFirstOrder at the sizes of
``tests/test_fdtd.py`` (each element projection and alias, a convex and a
matrix probe, absorption and B/A in the medium, ``record='field'``,
``bg_subtract``).

What each is held to. The port's spectral derivative transforms the whole
grid, with kappa(|k|), as k-Wave does; the JAX package's 2-D and 3-D
steppers transform along one axis and index kappa's other axes by the
grid's columns, which slows a plane wave down the grid's middle column
(``test_plane_wave_speed``: JAX 1518 m/s for 1540 on a 16-column grid, the
port within 0.08 % in 2-D and 3-D).
So: the 1-D stepper against JAX's (one axis, the same scheme); the 2-D and
3-D steppers against JAX's with kappa = 1 (``c_ref = 0``, which also turns
the PML off), where the two schemes are the same; and with kappa against a
float64 numpy implementation of the k-Wave scheme in this file. The
system-level kspaceFirstOrder against JAX's with JAX's stepper replaced,
for the call, by the port's on the CPU (the JAX package is not edited): the
grid, maps, time step, projections, sources, sensors, downsampling, field
crop and background subtraction are the JAX package's, and the numbers
must agree; then the JAX package's physics tests on the port's results.

Tolerances, max|port - ref| against max|ref| (measured on this CPU, bound
a little above): the steppers against JAX 2e-4 (measured up to 1.5e-4 on a
63^2 heterogeneous grid, 1.5e-6 in 1-D, 2.2e-6 in 3-D: float32 rounding of
the FFTs gathers over the steps) and against the float64 reference 2e-4
(measured up to 1.3e-4 in 2-D, 1.6e-6 in 3-D); batched
sources against single runs 1e-4 (measured 3.1e-5: the batched FFTs round
differently); kspaceFirstOrder 1e-4, the float32 standard (measured up to
1.9e-7: the same stepper, the sensors' sums in float32 against JAX's
float64); with background subtraction, the difference of two runs, 1e-3
of the background-free peak.
"""
import inspect
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
from qups_tpu.sim import fdtd as jfdtd  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.sim import fdtd  # noqa: E402

STEP_TOL = 2e-4
F32 = 1e-4
C0, FC = 1500.0, 2e6
LAM = C0 / FC


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def pulse(steps, dt, t0=0.8e-6, fc=2e6):
    t = np.arange(steps) * dt
    return (np.exp(-((t - t0) * fc * 2) ** 2) * np.sin(2 * np.pi * fc * t)).astype(np.float32)


def media(shape, seed):
    """Mildly heterogeneous speed and density maps and the physics maps."""
    rng = np.random.default_rng(seed)
    c = 1500.0 + rng.uniform(0, 60, shape)
    rho = 1000.0 + rng.uniform(0, 200, shape)
    return c, rho, np.full(shape, 0.75), np.full(shape, 8.0)


PHYSICS = {"lossless": (False, False), "absorbing": (True, False),
           "nonlinear": (False, True), "both": (True, True)}


def physics_kw(name, a, b):
    absorb, nonlin = PHYSICS[name]
    kw = {"alpha_power": 1.3}
    if absorb:
        kw["alpha0"] = a
    if nonlin:
        kw["bona"] = b
    return kw


@pytest.mark.parametrize("physics", list(PHYSICS))
@pytest.mark.parametrize("n", [64, 63])
def test_kspace_sim_2d_matches_jax_without_kappa(n, physics):
    h = 0.2e-3
    c, rho, a, b = media((n, n), 1)
    dt = 0.3 * h / c.max()
    steps = 48
    sig = np.stack([pulse(steps, dt), -0.5 * pulse(steps, dt, t0=0.6e-6)], 1)
    rows, cols = np.array([14, 14]), np.array([20, 40])
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=0.0, record_rows=(36, 50),
              field_stride=10 if physics == "both" else 0, **physics_kw(physics, a, b))
    ref = jfdtd.kspace_sim_2d(c, rho, rows, cols, sig, **kw)
    got = fdtd.kspace_sim_2d(c, rho, rows, cols, sig, device="cpu", **kw)
    if kw["field_stride"]:
        (ref, fref), (got, fgot) = ref, got
        assert fgot.shape == (5, n, n)
        assert rel(fgot, fref) < STEP_TOL
    assert got.shape == (steps, 2, n)
    assert rel(got, ref) < STEP_TOL


@pytest.mark.parametrize("physics", ["lossless", "both"])
@pytest.mark.parametrize("n", [24, 23])
def test_kspace_sim_3d_matches_jax_without_kappa(n, physics):
    h = 0.4e-3
    c, rho, a, b = media((n, n, n), 2)
    dt = 0.3 * h / c.max()
    steps = 30
    sig = pulse(steps, dt, t0=1.2e-6, fc=1.5e6)[:, None]
    src = np.array([[6], [12], [11]])
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=0.0, record_rows=(12, 16),
              field_stride=7, **physics_kw(physics, a, b))
    ref, fref = jfdtd.kspace_sim_3d(c, rho, src, sig, **kw)
    got, fgot = fdtd.kspace_sim_3d(c, rho, src, sig, device="cpu", **kw)
    assert got.shape == (steps, 2, n, n) and fgot.shape == (5, n, n, n)
    assert rel(got, ref) < STEP_TOL
    assert rel(fgot, fref) < STEP_TOL


@pytest.mark.parametrize("physics", list(PHYSICS))
def test_kspace_sim_1d_matches_jax(physics):
    h = 0.2e-3
    c, rho, a, b = media((256,), 3)
    dt = 0.3 * h / c.max()
    steps = 400
    sig = pulse(steps, dt, t0=1e-6)[:, None]
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=float(c.max()), record_rows=(60, 140),
              field_stride=50, **physics_kw(physics, a, b))
    ref, fref = jfdtd.kspace_sim_1d(c, rho, np.array([40]), sig, **kw)
    got, fgot = fdtd.kspace_sim_1d(c, rho, np.array([40]), sig, device="cpu", **kw)
    assert got.shape == (steps, 2) and fgot.shape == (8, 256)
    assert rel(got, ref) < STEP_TOL
    assert rel(fgot, fref) < STEP_TOL


def reference_stepper(c, rho, src, sig, *, steps, dt, dx, c_ref, rows, npml, alpha0=None,
                      alpha_power=1.5, bona=None, field_stride=0):
    """The k-space PSTD scheme in float64 numpy (k-Wave's operator: the
    derivative along axis d is ``real(ifftn(1j k_d kappa(|k|) e^{+-i k_d dx
    / 2} fftn(f)))``), written apart from the port's code; ``src (nd, Q)``,
    ``sig (steps, Q)``. Returns the recorded planes and the snapshots."""
    shape, nd = c.shape, c.ndim
    K = np.meshgrid(*[np.fft.fftfreq(n, dx) * 2 * np.pi for n in shape], indexing="ij")
    Kmag = np.sqrt(sum(k ** 2 for k in K))
    kappa = np.sinc(c_ref * Kmag * dt / 2 / np.pi)
    fwd = [1j * K[d] * kappa * np.exp(1j * K[d] * dx / 2) for d in range(nd)]
    bwd = [1j * K[d] * kappa * np.exp(-1j * K[d] * dx / 2) for d in range(nd)]
    pml = []
    for d, n in enumerate(shape):
        x = np.zeros(n)
        if npml:
            ramp = (np.arange(1, npml + 1) / npml) ** 4
            x[:npml], x[-npml:] = ramp[::-1], ramp
        pml.append(np.exp(-2.0 * c_ref / dx * x * dt / 2).reshape(
            [-1 if a == d else 1 for a in range(nd)]))
    op = lambda f, o: np.real(np.fft.ifftn(o * np.fft.fftn(f)))  # noqa: E731
    if alpha0 is not None:
        y = alpha_power
        a_np = 100.0 * alpha0 * (1e-6 / (2 * np.pi)) ** y / (20.0 * np.log10(np.e))
        tau, eta = -2.0 * a_np * c ** (y - 1.0), 2.0 * a_np * c ** y * np.tan(np.pi * y / 2.0)
        with np.errstate(divide="ignore"):
            nab1, nab2 = Kmag ** (y - 2.0), Kmag ** (y - 1.0)
        nab1[~np.isfinite(nab1)] = 0.0
        nab2[~np.isfinite(nab2)] = 0.0
    u = [np.zeros(shape) for _ in range(nd)]
    r = [np.zeros(shape) for _ in range(nd)]
    p = np.zeros(shape)
    src = tuple(np.asarray(src).reshape(nd, -1))
    rec, fld = [], []
    for i in range(steps):
        for d in range(nd):
            u[d] = pml[d] * (pml[d] * u[d] - dt / rho * op(p, fwd[d]))
        du = [op(u[d], bwd[d]) for d in range(nd)]
        for d in range(nd):
            r[d] = pml[d] * (pml[d] * r[d] - dt * rho * du[d])
            np.add.at(r[d], src, sig[i] / (nd * c[src] ** 2))
        rho_t, divu = sum(r), sum(du)
        pr = rho_t
        if bona is not None:
            pr = pr + bona / (2.0 * rho) * rho_t * rho_t
        if alpha0 is not None:
            pr = pr + tau * op(rho * divu, nab1) + eta * op(rho_t, nab2)
        p = c * c * pr
        rec.append(p[list(rows)])
        if field_stride and i % field_stride == 0:
            fld.append(p)
    return np.stack(rec), np.stack(fld) if fld else None


@pytest.mark.parametrize("physics", ["lossless", "both"])
@pytest.mark.parametrize("shape", [(64, 64), (63, 63), (24, 24, 24), (23, 23, 23)])
def test_kspace_sims_match_float64_reference(shape, physics):
    """With kappa (c_ref the largest speed) and the PML, the 2-D and 3-D
    steppers against the float64 k-Wave scheme above."""
    nd = len(shape)
    h = 0.2e-3 if nd == 2 else 0.4e-3
    c, rho, a, b = media(shape, 5)
    dt = 0.3 * h / c.max()
    steps = 48 if nd == 2 else 30
    sig = pulse(steps, dt, t0=0.8e-6 if nd == 2 else 1.2e-6)[:, None]
    src = np.array([[6], [shape[1] // 3]] + ([[shape[2] // 2]] if nd == 3 else []))
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=float(c.max()), field_stride=10,
              **physics_kw(physics, a, b))
    rows = (shape[0] // 2, shape[0] - 14)
    ref, fref = reference_stepper(c, rho, src, sig, rows=rows, npml=10 if nd == 2 else 8, **kw)
    sim = fdtd.kspace_sim_2d if nd == 2 else fdtd.kspace_sim_3d
    args = (src[0], src[1]) if nd == 2 else (src,)
    got, fgot = sim(c, rho, *args, sig, record_rows=rows, device="cpu", **kw)
    assert rel(got, ref) < STEP_TOL
    assert rel(fgot, fref) < STEP_TOL


def _delay(a, b, dt):
    """The delay of trace b behind trace a, from the peak of their cross-
    correlation with a parabola through its three top samples."""
    n = 2 * len(a)
    cc = np.fft.irfft(np.fft.rfft(b, n) * np.conj(np.fft.rfft(a, n)), n)
    k = int(np.argmax(cc[: len(a)]))
    y0, y1, y2 = cc[k - 1], cc[k], cc[k + 1]
    return (k + 0.5 * (y0 - y2) / (y0 - 2 * y1 + y2)) * dt


@pytest.mark.parametrize("nd", [2, 3])
def test_plane_wave_speed(nd):
    """A plane wave down the grid crosses 80 cells at the medium's speed,
    in the grid's middle column as at its first: within 0.1 %. The JAX
    package's 2-D stepper, whose kappa follows the column, runs it more
    than 1 % slow in the middle column (the fault this port leaves out)."""
    c0, h = 1540.0, 0.05e-3
    shape = (160, 16) if nd == 2 else (160, 8, 8)
    dt = 0.3 * h / c0
    steps = 420
    t = np.arange(steps) * dt
    s = (np.exp(-((t - 0.3e-6) * 10e6) ** 2) * np.sin(2 * np.pi * 7e6 * t)).astype(np.float32)
    nodes = np.stack(np.meshgrid(*[np.arange(n) for n in shape[1:]], indexing="ij"), 0
                     ).reshape(nd - 1, -1)
    Q = nodes.shape[1]
    src = np.concatenate([np.full((1, Q), 20), nodes])
    sig = np.repeat(s[:, None], Q, 1)
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=c0, record_rows=(40, 120))
    maps = (np.full(shape, c0), np.full(shape, 1e3))
    if nd == 2:
        rec = fdtd.kspace_sim_2d(*maps, *src, sig, device="cpu", **kw)
    else:
        rec = fdtd.kspace_sim_3d(*maps, src, sig, device="cpu", **kw)
    rec = rec.reshape(steps, 2, -1).numpy()
    mid = rec.shape[2] // 2 + (shape[-1] // 2 if nd == 3 else 0)
    for col in (0, mid):
        speed = 80 * h / _delay(rec[:, 0, col], rec[:, 1, col], dt)
        assert abs(speed - c0) < 1e-3 * c0, (col, speed)
    if nd == 2:
        ref = np.asarray(jfdtd.kspace_sim_2d(*maps, *src, sig, **kw))
        speed = 80 * h / _delay(ref[:, 0, mid], ref[:, 1, mid], dt)
        assert speed < 0.99 * c0, speed


def test_batched_sources_equal_single_runs():
    """A leading batch of source signals gives each its own simulation."""
    n, h = 48, 0.2e-3
    c, rho, a, b = media((n, n), 4)
    dt = 0.3 * h / c.max()
    steps = 40
    sig = np.stack([np.stack([pulse(steps, dt), pulse(steps, dt, t0=0.5e-6)], 1),
                    np.stack([np.zeros(steps, np.float32), -pulse(steps, dt)], 1)], 1)
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=float(c.max()), record_rows=(30,),
              alpha0=a, bona=b, field_stride=9, device="cpu")
    rec, fld = fdtd.kspace_sim_2d(c, rho, [10, 10], [15, 30], sig, **kw)
    assert rec.shape == (steps, 2, 1, n) and fld.shape == (5, 2, n, n)
    for i in range(2):
        r1, f1 = fdtd.kspace_sim_2d(c, rho, [10, 10], [15, 30], sig[:, i], **kw)
        assert rel(rec[:, i], r1) < F32 and rel(fld[:, i], f1) < F32


def test_stepper_rejects_nodes_off_the_grid():
    with pytest.raises(ValueError):
        fdtd.kspace_sim_2d(np.full((8, 8), C0), np.full((8, 8), 1e3), [8], [0],
                           np.zeros((2, 1), np.float32), steps=2, dt=1e-8, dx=1e-4,
                           c_ref=C0, record_rows=(0,), device="cpu")


# --------------------------------------------------- kspaceFirstOrder
def pw_system(mod, numel=8, fs=4 * FC, xdc=None):
    xdc = xdc or mod.TransducerArray(numel=numel, pitch=LAM / 2, fc=FC)
    return mod.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=mod.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=C0),
        scan=mod.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8), z=np.linspace(1e-3, 6e-3, 8)),
        fs=fs)


def blob_medium(mod, z_t=4e-3, **kw):
    blob = lambda P: np.hypot(P[0], P[2] - z_t) < LAM / 4  # noqa: E731
    return mod.Medium(c0=C0, rho0=1000.0, pertreg=((blob, {"rho": 2200.0}),), **kw)


def grid(mod, h=LAM / 6):
    return mod.ScanCartesian(x=np.arange(-3e-3, 3e-3, h), y=[0.0],
                             z=np.arange(-0.5e-3, 6.5e-3, h))


def port_stepper(sim):
    """The port's stepper ``sim`` on the CPU in the JAX stepper's place:
    JAX arrays in, numpy out."""
    def run(*args, **kw):
        out = sim(*(np.asarray(a) for a in args), device="cpu", **kw)
        return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()
    return run


def run_both(us, med, cgrd, **kw):
    """kspaceFirstOrder of the JAX package, its stepper replaced for the
    call by the port's (see the module's docstring), and of the port, on
    the same system, medium and grid."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfdtd, "kspace_sim_2d", port_stepper(fdtd.kspace_sim_2d))
        mp.setattr(jfdtd, "kspace_sim_3d", port_stepper(fdtd.kspace_sim_3d))
        ref = us.kspaceFirstOrder(med, cgrd, **kw)
    got = from_reference(us).kspaceFirstOrder(from_reference(med), from_reference(cgrd),
                                              device="cpu", **kw)
    return ref, got


def check_chd(got, ref, tol=F32):
    assert isinstance(got.data, torch.Tensor) and got.data.device.type == "cpu"
    assert rel(got.data, ref.data) < tol
    np.testing.assert_allclose(got.t0_host, ref.t0_host, rtol=1e-6)
    assert got.fs == ref.fs


@pytest.mark.parametrize("el_proj", ["nearest", "linear", "karray", "karray-direct",
                                     "karray-depend"])
def test_kspace_first_order_projections_match_jax(el_proj):
    ref, got = run_both(pw_system(q), blob_medium(q), grid(q), el_proj=el_proj, tmax=8e-6)
    assert got.data.shape == (64, 8, 1)
    check_chd(got, ref)


def test_kspace_first_order_field_matches_jax():
    """After ``tests/test_fdtd.py:258``: ``record='field'`` snapshots,
    cropped of the PML, as a tensor on the device; they propagate."""
    (ref, fref), (got, fgot) = run_both(pw_system(q), q.Medium(c0=C0, rho0=1000.0), grid(q),
                                        record="field", field_stride=10, tmax=6e-6)
    check_chd(got, ref)
    assert isinstance(fgot, torch.Tensor) and fgot.shape == tuple(np.shape(fref))
    assert rel(fgot, fref) < F32
    early, late = fgot[0, 1].numpy(), fgot[0, -1].numpy()
    deep = slice(2 * fgot.shape[2] // 3, None)
    assert np.abs(late[deep]).max() > 10 * np.abs(early[deep]).max()


def test_kspace_first_order_bg_subtract_matches_jax():
    """After ``tests/test_fdtd.py:273-293``: background subtraction cancels
    in a homogeneous medium and keeps the echo of a scatterer."""
    us = pw_system(q)
    ref0, got0 = run_both(us, q.Medium(c0=C0, rho0=1000.0), grid(q), tmax=6e-6)
    _, gbg = run_both(us, q.Medium(c0=C0, rho0=1000.0), grid(q), tmax=6e-6,
                      bg_subtract=True)
    assert gbg.data.abs().max() < 1e-6 * got0.data.abs().max()
    ref, got = run_both(us, blob_medium(q), grid(q), tmax=8e-6, bg_subtract=True)
    full, _ = run_both(us, blob_medium(q), grid(q), tmax=8e-6)
    assert np.abs(got.data.numpy() - np.asarray(ref.data)).max() \
        < 1e-3 * np.abs(np.asarray(full.data)).max()
    x = got.data[:, 4, 0].numpy()
    t = got.time[:, 0, 0].numpy()
    t_echo = 2 * 4e-3 / C0
    sel = (t > 0.75 * t_echo) & (t < 1.4 * t_echo)
    assert abs(t[sel][np.abs(x[sel]).argmax()] - t_echo) < 10 * (LAM / 6) / C0
    assert np.abs(x[t < 0.4 * t_echo]).max() < 0.5 * np.abs(x[sel]).max()


def test_kspace_first_order_lossy_nonlinear_matches_jax():
    """The medium's absorption and B/A (and the ambient ones in the
    background run)."""
    med = blob_medium(q, alpha0=0.5, alpha_power=1.5, bona0=6.0)
    ref, got = run_both(pw_system(q), med, grid(q), tmax=8e-6)
    check_chd(got, ref)
    full = got
    ref, got = run_both(pw_system(q), med, grid(q), tmax=8e-6, bg_subtract=True)
    assert np.abs(got.data.numpy() - np.asarray(ref.data)).max() \
        < 1e-3 * float(full.data.abs().max())


def test_kspace_first_order_echo_tof_matches_jax():
    """After ``tests/test_fdtd.py:44``: 16 elements, a density scatterer at
    8 mm, the default window; the echo at 2 z / c within 10 grid steps."""
    xdc = q.TransducerArray(numel=16, pitch=LAM / 2, fc=FC)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=C0),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 41), z=np.linspace(2e-3, 11e-3, 41)),
        fs=4 * FC)
    cgrd = q.ScanCartesian(x=np.arange(-5e-3, 5e-3, LAM / 6), y=[0.0],
                           z=np.arange(-0.5e-3, 11.5e-3, LAM / 6))
    ref, got = run_both(us, blob_medium(q, z_t=8e-3), cgrd)
    check_chd(got, ref)
    x, t = got.data[:, 8, 0].numpy(), got.time[:, 0, 0].numpy()
    t_echo = 2 * 8e-3 / C0
    sel = t > 0.6 * t_echo
    assert abs(t[sel][np.abs(x[sel]).argmax()] - t_echo) < 10 * (LAM / 6) / C0


def test_kspace_first_order_convex_karray_matches_jax():
    """After ``tests/test_fdtd.py:315``: a convex probe through 'karray'."""
    xdc = q.TransducerConvex.from_pitch(LAM / 2, 15e-3, numel=16, fc=FC)
    us = pw_system(q, xdc=xdc)
    cgrd = q.ScanCartesian(x=np.arange(-5e-3, 5e-3, LAM / 6), y=[0.0],
                           z=np.arange(-1.5e-3, 10.5e-3, LAM / 6))
    ref, got = run_both(us, blob_medium(q, z_t=7e-3), cgrd, el_proj="karray", tmax=1.4e-5)
    check_chd(got, ref)


def test_kspace_first_order_3d_matrix_matches_jax():
    """After ``tests/test_fdtd.py:137``: a 6 x 6 matrix probe in a volume."""
    lam = C0 / 1.5e6
    xdc = q.TransducerMatrix(numd=(6, 6), pitch2=(lam / 2, lam / 2), fc=1.5e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=C0),
        scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 6), z=np.linspace(2e-3, 7e-3, 6)),
        fs=6e6)
    blob = lambda P: np.sqrt(P[0] ** 2 + P[1] ** 2 + (P[2] - 5e-3) ** 2) < lam / 3  # noqa: E731
    h = lam / 5
    cgrd = q.ScanCartesian(x=np.arange(-3.2e-3, 3.2e-3, h), y=np.arange(-3.2e-3, 3.2e-3, h),
                           z=np.arange(-0.6e-3, 6.6e-3, h))
    med = q.Medium(c0=C0, pertreg=((blob, {"rho": 2500.0}),))
    ref, got = run_both(us, med, cgrd, tmax=9e-6)
    assert (got.N, got.M) == (36, 1)
    check_chd(got, ref)


def test_kspace_first_order_fsa_transmits_match_jax():
    """Several transmits (FSA: one element each) run as one batch, each
    equal to JAX's simulation of it."""
    xdc = q.TransducerArray(numel=4, pitch=LAM / 2, fc=FC)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=4, c0=C0),
                            scan=q.ScanCartesian(x=np.linspace(-1e-3, 1e-3, 4),
                                                 z=np.linspace(2e-3, 5e-3, 4)), fs=4 * FC)
    ref, got = run_both(us, blob_medium(q), grid(q), tmax=6e-6, el_proj="linear")
    assert got.data.shape[1:] == (4, 4)
    check_chd(got, ref)


def test_kspace_first_order_mesh_raises():
    us = from_reference(pw_system(q))
    with pytest.raises(NotImplementedError, match="item 11"):
        us.kspaceFirstOrder(qt.Medium(c0=C0), mesh=object(), device="cpu")


def test_fdtd_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run there")
    us = from_reference(pw_system(q))
    c = np.full((8, 8), C0)
    sig = np.zeros((2, 1), np.float32)
    kw = dict(steps=2, dt=1e-8, dx=1e-4, c_ref=C0)
    calls = (lambda: us.kspaceFirstOrder(qt.Medium(c0=C0)),
             lambda: fdtd.kspace_sim_2d(c, c, [1], [1], sig, record_rows=(0,), **kw),
             lambda: fdtd.kspace_sim_1d(c[0], c[0], [1], sig, record_rows=(0,), **kw),
             lambda: fdtd.kspace_sim_3d(np.full((8, 8, 8), C0), np.full((8, 8, 8), C0),
                                        np.ones((3, 1), int), sig, record_rows=(0,), **kw))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _examples():
    objs = (fdtd.kspace_sim_2d, fdtd.kspace_sim_1d, qt.UltrasoundSystem.kspaceFirstOrder)
    return [(o.__qualname__, textwrap.dedent(inspect.getdoc(o).split("Example:", 1)[1]))
            for o in objs]


@pytest.mark.parametrize("name,code", _examples(), ids=lambda v: v[:32])
def test_docstring_examples_run(name, code):
    exec(compile(code, name, "exec"), {})
