"""The port's kspaceFirstOrder on the CPU at the sizes of
``tests/test_fdtd.py`` (each element projection and alias, a convex and a
matrix probe, absorption and B/A in the medium, ``record='field'``,
``bg_subtract``), the entry points' default device and the docstring
examples of the full-wave simulator. The steppers are in
``tests/test_torch_fdtd.py``; ``kspaceFirstOrder(mesh=)`` in
``tests/test_torch_parallel_sim.py``.

The port's stepper differs from the JAX package's in its spectral
derivative (``tests/test_torch_fdtd.py``'s docstring), so the system-level
kspaceFirstOrder is held to JAX's with JAX's stepper replaced, for the
call, by the port's on the CPU (the JAX package is not edited): the grid,
maps, time step, projections, sources, sensors, downsampling, field crop
and background subtraction are the JAX package's, and the numbers must
agree; then the JAX package's physics tests on the port's results.

Tolerances, max|port - ref| against max|ref|: kspaceFirstOrder 1e-4, the
float32 standard (measured up to 1.9e-7: the same stepper, the sensors'
sums in float32 against JAX's float64); with background subtraction, the
difference of two runs, 1e-3 of the background-free peak.
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

from test_torch_fdtd import C0, F32, FC, LAM, rel  # noqa: E402


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
