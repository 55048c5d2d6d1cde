"""The port's counterpart of ``tests/test_sweep.py`` (the reference's
USTest, ``test/USTest.m:14-72``): the cartesian product of transducer,
sequence, scan and beamformer, on the CPU. Every case builds its system in
the JAX package, carries it across (``from_reference``) and holds the port
to the JAX package on the same system and the same traces: the simulated
traces (``greens``, ``calc_scat_multi``, ``kspaceFirstOrder``) against
JAX's, then each beamformer on JAX's traces against JAX's image. The JAX
tests' own oracles (shapes, finite values, the peak's position) then run on
the port's images. ``test_volumetric_sharded_das`` has its counterpart in
``tests/test_torch_parallel_das.py``.

Tolerances, max|port - JAX| < tol * max|JAX|: 1e-4, the float32 standard,
for the traces, DAS, bfDAS, bfEikonal and bfMigration; 2e-3 for bfAdjoint
in float32 against the JAX XLA engine, which builds its phases by a direct
cexp (``tests/test_torch_fdbf.py``; the port's default, bf16 operands,
then takes the oracle). bfMigration is held to op-by-op JAX
(``jax.disable_jit``), as ``tests/test_torch_refocus.py`` holds it: under
``jit`` XLA rounds the steep remap index differently (ROADMAP, Queue 3).
``kspaceFirstOrder`` is held to JAX's with JAX's stepper replaced by the
port's for the call (``tests/test_torch_fdtd_system.py``: the JAX
package's 2-D stepper indexes kappa by the grid's columns, Queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import qups_tpu as q  # noqa: E402
from qups_tpu.sim import fdtd as jfdtd  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.sim import fdtd  # noqa: E402

from test_sweep import C0, make_scan, make_seq, make_xdc  # noqa: E402
from test_torch_fdtd_system import port_stepper  # noqa: E402

F32 = 1e-4
ADJ = 2e-3  # bfAdjoint float32 against the JAX XLA engine
TARGET = np.array([0.0, 0.0, 25e-3])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: the suite runs six workers
    on the machine's cores, and many small torch operations spin every
    thread a worker has. Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def point():
    return q.Scatterers(pos=TARGET[:, None], c0=C0)


def simulate(us, scat=None):
    """JAX's traces and the port's, on the same system: (JAX ChannelData,
    the port's system, the port's ChannelData of JAX's traces)."""
    scat = scat or point()
    chd = us.greens(scat)
    ust = from_reference(us)
    got = ust.greens(from_reference(scat), device="cpu")
    assert rel(got.data, chd.data) < F32
    np.testing.assert_allclose(got.t0_host, np.asarray(chd.t0), rtol=1e-6)
    return chd, ust, from_reference(chd)


def beamform(us, ust, chd, chdt, bf, *args, tol=F32, port_kw=(), **kw):
    """``bf`` of the JAX system and of the port (with ``port_kw`` besides)
    on the same traces, held together; returns the port's image as numpy."""
    ref = np.asarray(getattr(us, bf)(chd, *args, **kw))
    targs = tuple(from_reference(a) for a in args)
    got = getattr(ust, bf)(chdt, *targs, device="cpu", **dict(port_kw), **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert rel(got, ref) < tol, (bf, rel(got, ref))
    return got.numpy()


def peak_error(us, img, target=TARGET):
    P = us.scan.positions().reshape(3, -1)
    return float(np.linalg.norm(P[:, int(np.abs(img).reshape(-1).argmax())] - target))


@pytest.mark.parametrize("xk", ["array", "convex", "matrix", "generic"])
@pytest.mark.parametrize("sk", ["FSA", "PW", "FC", "DV"])
def test_sim_and_das(xk, sk):
    xdc = make_xdc(xk)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=make_seq(sk, xdc.numel),
                            scan=make_scan("cart"), fs=12e6)
    chd, ust, chdt = simulate(us)
    b = beamform(us, ust, chd, chdt, "DAS")
    assert b.shape[:3] == us.scan.shape
    assert np.isfinite(np.abs(b)).all()


@pytest.mark.parametrize("ck", ["cart", "polar", "sphere", "generic"])
@pytest.mark.parametrize("bf", ["DAS", "bfDAS"])
def test_scans_and_beamformers(ck, bf):
    xdc = make_xdc("array")
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=make_seq("PW", xdc.numel),
                            scan=make_scan(ck), fs=12e6)
    chd, ust, chdt = simulate(us)
    b = beamform(us, ust, chd, chdt, bf)
    assert b.shape[:3] == us.scan.shape
    assert np.isfinite(np.abs(b)).all() and np.abs(b).max() > 0


def test_scale_units_mm_us():
    """The mm/us-rescaled system gives the same image up to amplitude, in
    the port as in JAX, and each system's image equals JAX's."""
    xdc = make_xdc("array")
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=make_seq("PW", 8),
                            scan=make_scan("cart"), fs=12e6)
    chd, ust, chdt = simulate(us)
    b1 = beamform(us, ust, chd, chdt, "DAS").squeeze()
    us2 = us.scale(dist=1e3, time=1e6)
    ust2 = ust.scale(dist=1e3, time=1e6)
    assert from_reference(us2).fs == ust2.fs
    np.testing.assert_allclose(ust2.scan.positions(), us2.scan.positions(), rtol=1e-12)
    chd2 = chd.replace(fs=chd.fs / 1e6, t0=chd.t0 * 1e6)
    chdt2 = chdt.replace(fs=chdt.fs / 1e6, t0=chdt.t0 * 1e6)
    b2 = beamform(us2, ust2, chd2, chdt2, "DAS").squeeze()
    i1 = np.unravel_index(np.abs(b1).argmax(), b1.shape)
    i2 = np.unravel_index(np.abs(b2).argmax(), b2.shape)
    assert abs(i1[0] - i2[0]) <= 1 and abs(i1[1] - i2[1]) <= 1
    c = np.abs(np.vdot(b1, b2)) / (np.linalg.norm(b1) * np.linalg.norm(b2))
    assert c > 0.95, c


@pytest.mark.parametrize("ck", ["cart", "polar"])
@pytest.mark.parametrize("sk", ["PW", "FC"])
@pytest.mark.parametrize("bf", ["bfEikonal", "bfAdjoint"])
def test_advanced_beamformers_scans_sequences(ck, sk, bf):
    xdc = make_xdc("array")
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=make_seq(sk, xdc.numel),
                            scan=make_scan(ck), fs=12e6)
    chd, ust, chdt = simulate(us)
    if bf == "bfEikonal":
        cgrd = q.ScanCartesian(x=np.linspace(-6e-3, 6e-3, 49),
                               z=np.linspace(0.0, 36e-3, 145))
        b = beamform(us, ust, chd, chdt, bf, q.Medium(c0=C0), cgrd)
    else:
        # float32 against the JAX XLA engine, then the port's bf16 default
        beamform(us, ust, chd, chdt, bf, tol=ADJ, port_kw={"precision": "f32"})
        b = ust.bfAdjoint(chdt, device="cpu").numpy()
    assert b.shape[:3] == us.scan.shape
    assert np.isfinite(np.abs(b)).all() and np.abs(b).max() > 0
    err = peak_error(us, b)
    assert err < 2e-3, (bf, ck, sk, err)


def test_migration_pw_cart():
    """bfMigration (Stolt) on a PW cartesian system: the image on us.scan and
    the native scan equal op-by-op JAX's; the target is imaged."""
    xdc = make_xdc("array")
    us = q.UltrasoundSystem(tx=xdc, rx=xdc,
                            seq=q.SequenceRadial(type="PW", angles=[0.0], c0=C0),
                            scan=make_scan("cart"), fs=12e6)
    chd, ust, chdt = simulate(us)
    with jax.disable_jit():
        ref, rscan = us.bfMigration(chd)
    got, mscan = ust.bfMigration(chdt, device="cpu")
    assert rel(got, ref) < F32
    np.testing.assert_allclose(mscan.positions(), rscan.positions(), rtol=1e-6, atol=1e-12)
    img = got.abs().numpy().squeeze()
    assert np.isfinite(img).all() and img.max() > 0
    assert tuple(img.shape) == tuple(s for s in us.scan.shape if s > 1)
    assert mscan.shape[0] > 0


def test_baseline_config3_convex_walking_polar():
    """BASELINE.json config #3: a focused walking-aperture sequence on a
    TransducerConvex imaged on a ScanPolar, through calc_scat_multi."""
    xdc = q.TransducerConvex.from_pitch(0.5e-3, 40e-3, numel=16, fc=3e6)
    M = 5
    th = np.radians(np.linspace(-10, 10, M))
    pf = np.stack([(40e-3 + 25e-3) * np.sin(th), np.zeros(M),
                   (40e-3 + 25e-3) * np.cos(th) - 40e-3 + xdc.positions()[2].max()])
    apd = q.Sequence.ap_walking(16, 8, stride=2)[:, :M]
    seq = q.Sequence(type="FC", focus=pf, c0=C0, apd=apd)
    scan = q.ScanPolar(r=np.linspace(15e-3, 35e-3, 24), a=np.linspace(-12, 12, 16))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=12e6)
    scat = point()
    chd = us.calc_scat_multi(scat)
    ust = from_reference(us)
    got = ust.calc_scat_multi(from_reference(scat), device="cpu")
    assert tuple(got.data.shape[1:3]) == (16, M)
    assert rel(got.data, chd.data) < F32
    b = beamform(us, ust, chd, from_reference(chd), "DAS")
    img = np.abs(b).squeeze()
    assert np.isfinite(img).all() and img.max() > 0
    assert peak_error(us, img) < 2.5e-3


@pytest.mark.parametrize("ck", ["sphere", "generic"])
@pytest.mark.parametrize("bf", ["DAS", "bfDAS"])
def test_spherical_generic_localization(ck, bf):
    """FSA onto a ScanSpherical and a ScanGeneric: the image equals JAX's,
    and its peak lies at the target's range and azimuth (a 1-D aperture
    does not resolve elevation)."""
    xdc = make_xdc("array")
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=make_seq("FSA", xdc.numel),
                            scan=make_scan(ck), fs=12e6)
    chd, ust, chdt = simulate(us)
    img = np.abs(beamform(us, ust, chd, chdt, bf)).squeeze()
    P = us.scan.positions().reshape(3, -1)
    p = P[:, int(img.reshape(-1).argmax())]
    assert abs(np.linalg.norm(p) - 25e-3) < 2e-3, (ck, bf)
    assert abs(np.degrees(np.arctan2(p[0], p[2]))) < 4.0, (ck, bf)


def test_fdtd_sim_to_beamform_psf():
    """kspaceFirstOrder's traces through DAS and bfEikonal: the traces equal
    JAX's (its stepper the port's for the call), each image equals JAX's on
    the same traces, and each localizes the density blob within 10 grid
    steps."""
    c0, fc = 1500.0, 2e6
    lam = c0 / fc
    h = lam / 6
    xdc = q.TransducerArray(numel=16, pitch=lam / 2, fc=fc)
    z_t = 8e-3
    scan = q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 31), z=np.linspace(5e-3, 11e-3, 41))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc,
                            seq=q.Sequence(type="PW", focus=[[0.0], [0.0], [1.0]], c0=c0),
                            scan=scan, fs=4 * fc)
    blob = lambda P: (np.hypot(P[0], P[2] - z_t) < lam / 4)  # noqa: E731
    med = q.Medium(c0=c0, rho0=1000.0, pertreg=((blob, {"rho": 2000.0}),))
    cgrd = q.ScanCartesian(x=np.arange(-5e-3, 5e-3, h), y=[0.0],
                           z=np.arange(-0.5e-3, 11.5e-3, h))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfdtd, "kspace_sim_2d", port_stepper(fdtd.kspace_sim_2d))
        chd = us.kspaceFirstOrder(med, cgrd)
    ust = from_reference(us)
    got = ust.kspaceFirstOrder(from_reference(med), from_reference(cgrd), device="cpu")
    assert rel(got.data, chd.data) < F32
    chdt = from_reference(chd)
    imgs = {"DAS": beamform(us, ust, chd, chdt, "DAS"),
            "bfEikonal": beamform(us, ust, chd, chdt, "bfEikonal", q.Medium(c0=c0), cgrd)}
    for name, b in imgs.items():
        a = np.abs(b).squeeze()
        assert a.shape == us.scan.shape[:2] and np.isfinite(a).all(), name
        assert peak_error(us, a, [0.0, 0.0, z_t]) < 10 * h, name
