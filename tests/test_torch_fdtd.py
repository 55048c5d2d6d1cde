"""The port's k-space full-wave steppers on the CPU (1-D, 2-D and 3-D; even
and odd grids; lossless, absorbing, nonlinear and both; field snapshots;
batched sources) at the sizes of ``tests/test_fdtd.py``. The system-level
``kspaceFirstOrder`` is in ``tests/test_torch_fdtd_system.py``.

What each is held to. The port's spectral derivative transforms the whole
grid, with kappa(|k|), as k-Wave does; the JAX package's 2-D and 3-D
steppers transform along one axis and index kappa's other axes by the
grid's columns, which slows a plane wave down the grid's middle column
(``test_plane_wave_speed``: JAX 1518 m/s for 1540 on a 16-column grid, the
port within 0.08 % in 2-D and 3-D).
So: the 1-D stepper against JAX's (one axis, the same scheme); the 2-D and
3-D steppers against JAX's with kappa = 1 (``c_ref = 0``, which also turns
the PML off), where the two schemes are the same; and with kappa against a
float64 numpy implementation of the k-Wave scheme in this file.

Tolerances, max|port - ref| against max|ref| (measured on this CPU, bound
a little above): the steppers against JAX 2e-4 (measured up to 1.5e-4 on a
63^2 heterogeneous grid, 1.5e-6 in 1-D, 2.2e-6 in 3-D: float32 rounding of
the FFTs gathers over the steps) and against the float64 reference 2e-4
(measured up to 1.3e-4 in 2-D, 1.6e-6 in 3-D); batched
sources against single runs 1e-4 (measured 3.1e-5: the batched FFTs round
differently).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qups_tpu.sim import fdtd as jfdtd  # noqa: E402
from qups_tpu_torch.sim import fdtd  # noqa: E402

STEP_TOL = 2e-4
F32 = 1e-4
C0, FC = 1500.0, 2e6
LAM = C0 / FC


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: the suite runs six workers
    on the machine's cores, and the steppers' many small operations spin
    every thread a worker has (in the full run a 0.6 s test took 159 s).
    Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
