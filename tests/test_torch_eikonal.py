"""The port's eikonal beamformer against qups_tpu, on the CPU: Medium
(props of the ambient medium, a perturbation region, Sampled, Diffuse),
gridded_interp, the fast-marching solver (the port's native build and its
Python solver against the JAX package's), eikonal_tables (FSA, PW, FC and
DV in 2-D, FSA in 3-D) and bfEikonal(device="cpu"), whose K2 step runs its
plain version here; then the JAX package's physics tests as port tests
(homogeneous eikonal = bfDAS, the slow lens, the straight-ray limits).

Tolerances: Medium's maps and the solvers' travel-time maps bit for bit
(the same float64 numpy, and the same C++ source built with the same
flags: the native maps came out equal, so the test holds them to 0, well
inside 1e-12 relative); gridded_interp 1e-12 relative; the tables within
one float32 rounding of the largest delay; bfEikonal 1e-4 x max, the float32
standard of the beamformers' tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
from qups_tpu.ops import eikonal as jeik  # noqa: E402
from qups_tpu.utils.maths import gridded_interp as j_interp  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import _nvcc, eikonal  # noqa: E402
from qups_tpu_torch.utils.maths import gridded_interp  # noqa: E402

C0, CS = 1540.0, 1300.0


def lens(mod):
    return mod.Medium(c0=C0, pertreg=((lambda P: P[2] < 5e-3, {"c": CS}),))


GRID = dict(x=np.linspace(-3e-3, 3e-3, 13), y=[0.0], z=np.linspace(0.0, 8e-3, 17))
MEDIA = {
    "ambient": lambda mod, scan: mod.Medium(c0=1500.0, rho0=1020.0),
    "lens": lambda mod, scan: lens(mod),
    "sampled nearest": lambda mod, scan: mod.Medium.Sampled(
        scan, c=1500 + 40 * np.random.default_rng(3).random(scan.shape),
        rho=np.full(scan.shape, 990.0), method="nearest"),
    "sampled linear": lambda mod, scan: mod.Medium.Sampled(
        scan, c=1500 + 40 * np.random.default_rng(4).random(scan.shape), method="linear"),
    "sampled cubic": lambda mod, scan: mod.Medium.Sampled(
        scan, c=1500 + 40 * np.random.default_rng(5).random(scan.shape), c0=1480.0),
    "diffuse": lambda mod, scan: mod.Medium.Diffuse(scan, rho_scat=0.1, seed=7),
}


@pytest.mark.parametrize("name", sorted(MEDIA))
def test_medium_props_match_reference(name):
    """props for every property, bit for bit, on a finer, shifted grid
    (the Sampled lookups interpolate; Diffuse's noise lives on its own
    grid, so it is read there); a JAX Medium carried across by
    from_reference gives the same maps."""
    js, ts = q.ScanCartesian(**GRID), qt.ScanCartesian(**GRID)
    jm, tm = MEDIA[name](q, js), MEDIA[name](qt, ts)
    fine = GRID if name == "diffuse" else dict(
        x=np.linspace(-3.1e-3, 2.9e-3, 23), y=[0.0], z=np.linspace(0.1e-3, 8e-3, 31))
    keys = ["c", "rho", "bona", "alpha"]
    ref = jm.props(q.ScanCartesian(**fine), keys)
    got = tm.props(qt.ScanCartesian(**fine), keys)
    carried = from_reference(jm).props(qt.ScanCartesian(**fine), keys)
    assert isinstance(from_reference(jm), qt.Medium)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(carried[k], ref[k])
    np.testing.assert_array_equal(tm.props(ts, "c"), jm.props(js, "c"))


def test_medium_scale_and_replace():
    jm, tm = lens(q), lens(qt)
    for a, b in ((jm.scale(dist=1e3, time=1e6), tm.scale(dist=1e3, time=1e6)),
                 (jm.replace(rho0=900.0), tm.replace(rho0=900.0))):
        assert (a.c0, a.rho0, a.alpha_power) == (b.c0, b.rho0, b.alpha_power)
    assert qt.Medium().c0 == q.Medium().c0 and np.isnan(qt.Medium().bona0)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_gridded_interp_matches_reference(method, ndim):
    """Every method in 2-D and 3-D, with queries off both ends of each axis
    (the clamped edge taps) and a size-1 axis, within 1e-12 relative."""
    rng = np.random.default_rng(10 + ndim)
    shape = (9, 7, 1)[:ndim] if ndim == 3 else (9, 7)
    vals = rng.standard_normal(shape)
    fis = [rng.uniform(-2, n + 1, 200) for n in shape]
    ref = j_interp(vals, fis, method=method)
    got = gridded_interp(vals, fis, method=method)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    with pytest.raises(ValueError):
        gridded_interp(vals, fis, method="spline")


SOLVES = {
    "2d": (lambda rng: 1500 + 200 * rng.random((41, 43)), [(5, 7)], None),
    "2d two sources t0": (lambda rng: 1500 + 200 * rng.random((41, 43)),
                          [(5, 7), (30, 20)], [1e-6, 2e-6]),
    "3d": (lambda rng: 1500 + 200 * rng.random((15, 16, 17)), [(3, 4, 5)], None),
    "3d t0": (lambda rng: 1500 + 200 * rng.random((15, 16, 17)), [(3, 4, 5), (10, 2, 9)],
              [1e-6, 0.5e-6]),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_msfm_native_matches_reference(case):
    """The port's build of its copy of msfm.cpp against the JAX package's
    native solver, same source and flags: equal maps."""
    if jeik._load_native() is None:
        pytest.skip("the JAX package's native msfm is unavailable")
    make, src, t0 = SOLVES[case]
    F = make(np.random.default_rng(20))
    for order2 in (True, False):
        ref = jeik.msfm(F, 1e-3, src, order2=order2, use_native=True, src_t0=t0)
        got = eikonal.msfm(F, 1e-3, src, order2=order2, use_native=True, src_t0=t0)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["2d", "2d two sources t0", "3d t0"])
def test_msfm_python_matches_reference(case):
    """_msfm_py against the JAX package's, and against the native solver
    (1e-6 relative, the JAX package's own standard for the pair)."""
    make, src, t0 = SOLVES[case]
    F = make(np.random.default_rng(21))
    ref = jeik._msfm_py(F, 1e-3, np.asarray(src), True, t0)
    got = eikonal._msfm_py(F, 1e-3, np.asarray(src), True, t0)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(eikonal.msfm(F, 1e-3, src, use_native=False, src_t0=t0), ref)
    nat = eikonal.msfm(F, 1e-3, src, use_native=True, src_t0=t0)
    assert np.allclose(nat, got, rtol=1e-6, atol=1e-12)


def test_msfm_multi_matches_reference():
    F = 1500 + 100 * np.random.default_rng(22).random((31, 33))
    srcs = [(0, 5), (0, 15), (3, 25)]
    ref = jeik.msfm_multi(F, 1e-3, srcs, workers=2)
    got = eikonal.msfm_multi(F, 1e-3, srcs, workers=2)
    assert got.shape == (3, 31, 33)
    np.testing.assert_array_equal(got, ref)
    for k, s in enumerate(srcs):
        assert got[k][s] == 0


def test_msfm_analytic_distance():
    """KernTest's oracle (``test/KernTest.m:409``): in a homogeneous medium
    T = r / c, interior error ~h."""
    n, h, c = 101, 1e-3, 1500.0
    T = eikonal.msfm(np.full((n, n), c), h, [(n // 2, n // 2)])
    z = (np.arange(n) - n // 2) * h
    R = np.hypot(*np.meshgrid(z, z, indexing="ij"))
    m = (R > 5 * h) & (R < 45 * h)
    rel = np.abs(T[m] - R[m] / c) / (R[m] / c)
    assert rel.mean() < 0.01 and rel.max() < 0.05


def test_native_solver_builds_in_the_port(monkeypatch):
    """The native solver is the port's build: csrc/msfm.cpp compiled into
    qups_tpu_torch/_build/, never the JAX package's native directory; with
    no host compiler msfm runs the Python solver, and use_native=True
    raises."""
    from pathlib import Path

    lib = eikonal.native()
    so = Path(lib._name).resolve()
    assert so.parent == _nvcc.BUILD_DIR.resolve() and so.name.startswith("msfm_")
    assert "qups_tpu/native" not in str(so)
    F = 1500 + 100 * np.random.default_rng(23).random((21, 22))
    monkeypatch.setattr(eikonal, "_LIB", None)
    monkeypatch.setattr(_nvcc, "host_cxx", lambda: None)
    assert eikonal.native() is None
    np.testing.assert_array_equal(eikonal.msfm(F, 1e-3, [(2, 3)]),
                                  eikonal._msfm_py(F, 1e-3, np.array([[2, 3]]), True))
    with pytest.raises(RuntimeError, match="compiler"):
        eikonal.msfm(F, 1e-3, [(2, 3)], use_native=True)
    with pytest.raises(RuntimeError, match="compiler"):
        _nvcc.load_host("msfm_missing")


def test_msfm_rejects_sources_off_the_grid():
    F = np.full((11, 12), 1500.0)
    for src in ([(11, 0)], [(0, -1)], [(3, 4), (2, 12)]):
        for use_native in (None, False):
            with pytest.raises(ValueError, match="outside"):
                eikonal.msfm(F, 1e-3, src, use_native=use_native)


def _table_systems(mod):
    """The JAX tests' systems: a 32-element array with FSA, PW (+-8 deg),
    FC (12 mm) and DV (apexes behind the array, outside the grid), and a
    4 x 2 matrix with FSA on a 3-D grid."""
    xdc = mod.TransducerArray(numel=32, pitch=0.4e-3, fc=5e6)
    scan = mod.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 24), y=[0.0],
                             z=np.linspace(8e-3, 20e-3, 32))
    h = 0.2e-3
    cgrd = mod.ScanCartesian(x=np.arange(-8e-3, 8e-3, h), y=[0.0],
                             z=np.arange(0.0, 24e-3, h))
    ang = np.radians([-8.0, 0.0, 8.0])
    seqs = {"FSA": mod.Sequence(type="FSA", numpulse=32, c0=C0),
            "PW": mod.Sequence(type="PW", focus=np.stack([np.sin(ang), 0 * ang, np.cos(ang)]),
                               c0=C0),
            "FC": mod.Sequence(type="FC", focus=np.array([[0.0], [0.0], [12e-3]]), c0=C0),
            "DV": mod.Sequence(type="DV", focus=np.array([[0.0, 1e-3], [0.0, 0.0],
                                                          [-10e-3, -8e-3]]), c0=C0)}
    out = {k: (mod.UltrasoundSystem(tx=xdc, rx=xdc, seq=s, scan=scan, fs=20e6), cgrd)
           for k, s in seqs.items()}
    mx = mod.TransducerMatrix(numd=(4, 2), pitch2=(0.5e-3, 0.5e-3), fc=3e6)
    h3 = 0.25e-3
    out["FSA 3-D"] = (mod.UltrasoundSystem(
        tx=mx, rx=mx, seq=mod.Sequence(type="FSA", numpulse=mx.numel, c0=1500.0),
        scan=mod.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8), y=np.linspace(-1e-3, 1e-3, 4),
                               z=np.linspace(4e-3, 8e-3, 8)), fs=12e6),
        mod.ScanCartesian(x=np.arange(-4e-3, 4e-3, h3), y=np.arange(-2e-3, 2e-3, h3),
                          z=np.arange(0e-3, 10e-3, h3)))
    return out


@pytest.fixture(scope="module")
def table_systems():
    return _table_systems(q), _table_systems(qt)


@pytest.mark.parametrize("medium", ["homogeneous", "lens"])
@pytest.mark.parametrize("case", ["FSA", "PW", "FC", "DV", "FSA 3-D"])
def test_eikonal_tables_match_reference(table_systems, case, medium):
    """eikonal_tables(device="cpu") against the JAX package's: float32
    tensors (I, N) and (I, M) within one float32 rounding of the largest
    delay."""
    (jus, jg), (tus, tg) = table_systems[0][case], table_systems[1][case]
    jm, tm = (q.Medium(c0=C0), qt.Medium(c0=C0)) if medium == "homogeneous" \
        else (lens(q), lens(qt))
    ref = jus.eikonal_tables(jm, jg)
    got = tus.eikonal_tables(tm, tg, device="cpu")
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.device.type == "cpu" and g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= np.spacing(np.float32(np.abs(r).max()))


def _fsa16(mod, c_scat):
    xdc = mod.TransducerArray(numel=16, pitch=0.5e-3, fc=3e6)
    us = mod.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=mod.Sequence(type="FSA", numpulse=16, c0=C0),
        scan=mod.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 33),
                               z=np.linspace(20e-3, 36e-3, 33)), fs=24e6)
    return us, mod.Scatterers(pos=[[0.0], [0.0], [28e-3]], c0=c_scat)


def _lens_speed(z_target=28e-3):
    """The effective speed of a straight ray from the array to z_target
    through the 5 mm lens."""
    return z_target / (5e-3 / CS + (z_target - 5e-3) / C0)


@pytest.fixture(scope="module")
def fsa16():
    """The JAX tests' 16-element FSA system, its target simulated at c0
    and at the lens's effective speed, in both packages (the port's traces
    carried across from the JAX package's)."""
    out = {}
    for name, c in (("homogeneous", C0), ("lens", _lens_speed())):
        us, scat = _fsa16(q, c)
        chd = us.greens(scat)
        out[name] = (us, chd, from_reference(us), from_reference(chd))
    return out


@pytest.mark.parametrize("medium", ["homogeneous", "lens"])
def test_bf_eikonal_matches_reference(fsa16, medium):
    """bfEikonal(device="cpu") on the default grid against the JAX
    package's bfEikonal, within 1e-4 x max; kernel='plain' is the same call
    here."""
    us, chd, ust, chdt = fsa16[medium]
    jm, tm = (q.Medium(c0=C0), qt.Medium(c0=C0)) if medium == "homogeneous" \
        else (lens(q), lens(qt))
    ref = np.asarray(us.bfEikonal(chd, jm))
    got = ust.bfEikonal(chdt, tm, device="cpu")
    assert got.shape == ref.shape and got.dtype == torch.complex64
    assert np.abs(got.numpy() - ref).max() < 1e-4 * np.abs(ref).max()
    assert torch.equal(ust.bfEikonal(chdt, tm, device="cpu", kernel="plain"), got)


def test_bf_eikonal_homogeneous_matches_bfdas(fsa16):
    """In a homogeneous medium the eikonal delays are straight rays: the
    peaks within a pixel of bfDAS's, correlation > 0.9."""
    _, _, us, chd = fsa16["homogeneous"]
    b1 = us.bfEikonal(chd, qt.Medium(c0=C0), device="cpu").squeeze().numpy()
    b2 = us.bfDAS(chd, device="cpu").squeeze().numpy()
    i1 = np.unravel_index(np.abs(b1).argmax(), b1.shape)
    i2 = np.unravel_index(np.abs(b2).argmax(), b2.shape)
    assert abs(i1[0] - i2[0]) <= 1 and abs(i1[1] - i2[1]) <= 1
    c = np.abs(np.vdot(b1, b2)) / (np.linalg.norm(b1) * np.linalg.norm(b2))
    assert c > 0.9, c


def test_bf_eikonal_lens_shifts_focus(fsa16):
    """A 1300 m/s layer over the first 5 mm delays the echoes: the eikonal
    beamformer with the true medium puts the target within 1.1 mm, closer
    than bfDAS's homogeneous assumption."""
    _, _, us, chd = fsa16["lens"]
    P = us.scan.positions()
    zs = []
    for b in (us.bfEikonal(chd, lens(qt), device="cpu"), us.bfDAS(chd, device="cpu")):
        b = b.squeeze().numpy()
        iz, ix = np.unravel_index(np.abs(b).argmax(), b.shape)
        zs.append(P[2, iz, ix, 0])
    assert abs(zs[0] - 28e-3) < abs(zs[1] - 28e-3) + 1e-9
    assert abs(zs[0] - 28e-3) < 1.1e-3


def test_eikonal_tables_homogeneous_match_geometric(table_systems):
    """The Fermat and wavefront tx tables are the straight-ray tables of
    das_delay_tables in a homogeneous medium: PW within 5 h everywhere,
    FC within 5 h in the focal cone and never later outside it."""
    systems = table_systems[1]
    h = 0.2e-3
    us, cgrd = systems["PW"]
    tau_rx, tau_tx = us.eikonal_tables(qt.Medium(c0=C0), cgrd, device="cpu")
    g_rx, g_tx = us.das_delay_tables(device="cpu")
    assert float((tau_rx - g_rx).abs().max()) * C0 < 3 * h
    assert float((tau_tx - g_tx).abs().max()) * C0 < 5 * h
    us, cgrd = systems["FC"]
    tau_rx, tau_tx = us.eikonal_tables(qt.Medium(c0=C0), cgrd, device="cpu")
    g_rx, g_tx = us.das_delay_tables(device="cpu")
    P = us.scan.positions().reshape(3, -1)
    zf, half_ap = 12e-3, 0.4e-3 * (32 - 1) / 2
    cone = (P[2] > zf + 1e-3) & (np.abs(P[0]) < 0.7 * half_ap * (P[2] - zf) / zf)
    err = (tau_tx[:, 0] - g_tx[:, 0]).abs().numpy() * C0
    assert cone.sum() > 20 and err[cone].max() < 5 * h
    assert bool((tau_tx[:, 0] <= g_tx[:, 0] + 3 * h / C0).all())


def test_eikonal_tables_3d(table_systems):
    """3-D FSA maps match the analytic distance in a homogeneous volume."""
    us, cgrd = table_systems[1]["FSA 3-D"]
    tau_rx, tau_tx = us.eikonal_tables(qt.Medium(c0=1500.0), cgrd, device="cpu")
    P = us.scan.positions().reshape(3, -1)
    r = np.linalg.norm(P[:, :, None] - us.rx.positions()[:, None, :], axis=0)
    assert np.abs(tau_rx.numpy() - r / 1500.0).max() * 1500.0 < 4 * 0.25e-3
    assert torch.equal(tau_tx, tau_rx)


def _examples():
    import inspect
    import textwrap

    objs = (qt.UltrasoundSystem.eikonal_tables, qt.UltrasoundSystem.bfEikonal,
            qt.Medium.props, gridded_interp, eikonal.msfm)
    return [(o.__qualname__, textwrap.dedent(inspect.getdoc(o).split("Example:", 1)[1]))
            for o in objs]


@pytest.mark.parametrize("name,code", _examples(), ids=lambda v: v[:32])
def test_docstring_examples_run(name, code):
    exec(compile(code, name, "exec"), {})
