"""The port's display helpers (qups_tpu_torch.display) against
qups_tpu.display, on the CPU under matplotlib's Agg backend, and the
ported imaging demo (qups_tpu_torch/examples/demo_imaging.py).

Every case of tests/test_display.py runs on the port. Parity cases: the
same inputs, made from a seed with numpy, through both packages' helpers
give artists holding the same arrays (within 1e-4 dB; linear displays
within 1e-6 relative) with equal extents and labels. Two cases show where
the port departs from the JAX package on purpose (ROADMAP Queue 3): a real
image with two frames is two frames, not a real/imaginary pair; and
``chd_imagesc`` labels time with transmit m's own axis under a per-transmit
t0. The demo's ``main(device="cpu")`` runs on a reduced system (its
``system`` patched: 32 elements, 64 x 64 pixels; the phantom and sequence
as they are) and its four images are held to the JAX package's calls on the
same traces within 1e-4 of the peak (bfAdjoint 2e-3, as tests/test_torch_fdbf.py
holds it to the XLA engine), its two PNGs written to tmp_path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import qups_tpu as q  # noqa: E402
import qups_tpu.display as jdisplay  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch import display  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402


@pytest.fixture(autouse=True)
def _close():
    yield
    plt.close("all")


# -------------------------------------------- the cases of tests/test_display.py
def test_chd_imagesc_and_gif(tmp_path):
    rng = np.random.default_rng(0)
    chd = qt.ChannelData(data=rng.standard_normal((64, 16, 3)).astype(np.float32),
                         fs=20e6, t0=0.0)
    h = chd.imagesc(m=1)
    assert h.get_array().shape == (64, 16)
    anim = chd.gif()
    anim.save(tmp_path / "chd.gif", writer="pillow", dpi=40)
    assert (tmp_path / "chd.gif").stat().st_size > 0


def test_scan_imagesc_cartesian_and_polar():
    scan = qt.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 32), y=[0.0],
                            z=np.linspace(0, 20e-3, 64))
    b = np.random.rand(*scan.shape)
    h = scan.imagesc(b)
    assert h.get_array().size == 32 * 64
    pol = qt.ScanPolar(r=np.linspace(0, 20e-3, 48), a=np.linspace(-30, 30, 33))
    bp = np.random.rand(*pol.shape) + 0.1
    h2 = pol.imagesc(bp)
    assert h2.get_array().size > 0


def test_medium_xdc_scat_plots():
    scan = qt.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 16), y=[0.0],
                            z=np.linspace(0, 10e-3, 16))
    med = qt.Medium(c0=1540.0, pertreg=((lambda P: P[2] > 5e-3, {"c": 1600.0}),))
    h = med.imagesc(scan, "c")
    assert float(np.nanmax(h.get_array())) >= 1600.0 - 1
    xdc = qt.TransducerConvex(numel=16, radius=40e-3, fc=3e6)
    assert xdc.plot() is not None
    sc = qt.Scatterers(pos=np.array([[0, 1e-3], [0, 0], [5e-3, 8e-3]]))
    assert sc.plot() is not None


def test_image_gif(tmp_path):
    scan = qt.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 16), y=[0.0],
                            z=np.linspace(0, 10e-3, 16))
    frames = np.random.rand(*(tuple(scan.shape) + (1, 1, 4)))
    anim = scan.gif(frames.reshape(16, 16, 1, 4))
    anim.save(tmp_path / "img.gif", writer="pillow", dpi=40)
    assert (tmp_path / "img.gif").stat().st_size > 0


def _vol_scan(m, ny=4):
    return m.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 8), y=np.linspace(-2e-3, 2e-3, ny),
                           z=np.linspace(10e-3, 20e-3, 6))


def test_scan_imagesc_volume_slice():
    """3-D volumes display a named slice plane (Scan.imagesc slice/index,
    src/Scan.m:385-406), each kept axis labeled by its own letter."""
    scan = _vol_scan(qt)
    vol = np.random.default_rng(0).random(scan.shape)
    h = display.scan_imagesc(scan, vol, index=1)          # default: slice Y
    assert h.get_array().shape == (6, 8)
    assert h.axes.get_xlabel().startswith("x")
    h = display.scan_imagesc(scan, vol, slice="x", index=3)
    assert h.get_array().shape == (6, 4)
    assert h.axes.get_xlabel().startswith("y")
    assert h.axes.get_ylabel().startswith("z")
    ext = h.get_extent()
    assert ext[0] == -2.0 and ext[1] == 2.0      # y in mm
    assert ext[2] == 20.0 and ext[3] == 10.0     # z in mm, depth down
    h = display.scan_imagesc(scan, vol, slice="z", index=2)
    assert h.axes.get_xlabel().startswith("y")
    assert h.axes.get_ylabel().startswith("x")


def test_scan_vol3d():
    """vol3d analog (Scan.vol3d, src/Scan.m:512): MIP triptych and the
    alpha-composited plane stack; ny < 4 clamps alpha, and a numpy array of
    axes is accepted."""
    scan = _vol_scan(qt)
    vol = np.random.default_rng(1).random(scan.shape)
    assert len(display.scan_vol3d(scan, vol)) == 3
    assert len(display.scan_vol3d(scan, vol, mode="alpha")) == 4
    scan2 = _vol_scan(qt, ny=2)
    vol2 = np.random.default_rng(2).random(scan2.shape)
    assert len(display.scan_vol3d(scan2, vol2, mode="alpha")) == 2
    _, axs = plt.subplots(1, 3)
    assert len(display.scan_vol3d(scan, vol, axs=axs, mode="alpha")) == 4


def test_scan_imagesc_ri_channel():
    """``ri=True`` joins a trailing size-2 axis of real data as a
    real/imaginary pair (the JAX package's ``out='ri'`` images) and shows
    the complex envelope; vol3d joins it too."""
    scan = qt.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 32), y=[0.0],
                            z=np.linspace(0, 20e-3, 64))
    rng = np.random.default_rng(3)
    re = rng.standard_normal(tuple(scan.shape)).astype(np.float32)
    im = rng.standard_normal(tuple(scan.shape)).astype(np.float32)
    bri = np.stack([re, im], axis=-1)            # (64, 32, 1, 2)
    h = scan.imagesc(bri, dbr=None, ri=True)
    np.testing.assert_allclose(np.asarray(h.get_array()), np.abs(re + 1j * im)[:, :, 0],
                               rtol=1e-6)
    h2 = scan.imagesc(bri, dbr=None, ri=False)
    np.testing.assert_allclose(np.asarray(h2.get_array()), np.abs(re)[:, :, 0], rtol=1e-6)
    scan3 = qt.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 8), y=np.linspace(-2e-3, 2e-3, 4),
                             z=np.linspace(0, 8e-3, 8))
    b3 = rng.standard_normal(tuple(scan3.shape) + (2,)).astype(np.float32)
    assert len(display.scan_vol3d(scan3, b3, dbr=None, ri=True)) == 3


# ------------------------------------------------------------ parity cases
def _held(h):
    """(array, extent, labels) of an artist."""
    return (np.asarray(h.get_array(), np.float64), tuple(h.get_extent()),
            (h.axes.get_xlabel(), h.axes.get_ylabel()))


def same_artist(got, ref, db=True):
    """The artists hold the same arrays (within 1e-4 dB, or 1e-6 relative
    for a linear display), extents and labels."""
    (a, ea, la), (b, eb, lb) = _held(got), _held(ref)
    assert a.shape == b.shape and la == lb
    np.testing.assert_allclose(ea, eb, rtol=1e-7)
    if db:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12 * np.abs(b).max())
    for k in ("vmin", "vmax"):
        np.testing.assert_allclose(getattr(got.norm, k), getattr(ref.norm, k), rtol=0,
                                   atol=1e-4 if db else 1e-6 * abs(getattr(ref.norm, k)))


CHD_CASES = {
    "real": (False, 0.0, False), "real db": (False, 0.0, True),
    "complex": (True, 0.0, False), "frames": (False, 1.5e-6, True),
}


@pytest.mark.parametrize("name", list(CHD_CASES))
def test_chd_imagesc_parity(name):
    cplx, t0, db = CHD_CASES[name]
    rng = np.random.default_rng(4)
    shape = (80, 12, 3) + ((2,) if name == "frames" else ())
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = q.ChannelData(data=x, fs=20e6, t0=t0)
    got = from_reference(ref)
    kw = dict(m=2, db=db, frame=1 if name == "frames" else 0)
    same_artist(display.chd_imagesc(got, **kw), jdisplay.chd_imagesc(ref, **kw),
                db=db or cplx)


def test_chd_imagesc_time_axis_per_transmit_t0():
    """With a per-transmit t0 the port labels time with transmit m's own
    axis; the JAX package takes transmit 0's start and transmit M-1's end
    (ROADMAP Queue 3). A scalar t0 gives both the same extent."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((50, 8, 3)).astype(np.float32)
    fs, t0 = 10e6, np.array([1e-6, 2e-6, 4e-6])
    got = qt.ChannelData(data=x, fs=fs, t0=t0)
    ref = q.ChannelData(data=x, fs=fs, t0=t0.reshape(1, 1, 3))
    for m in range(3):
        ext = display.chd_imagesc(got, m=m).get_extent()
        np.testing.assert_allclose(ext[2:], [(t0[m] + 49 / fs) * 1e6, t0[m] * 1e6], rtol=1e-6)
    jext = jdisplay.chd_imagesc(ref, m=1).get_extent()
    np.testing.assert_allclose(jext[2:], [(t0[2] + 49 / fs) * 1e6, t0[0] * 1e6], rtol=1e-6)
    assert not np.allclose(jext, display.chd_imagesc(got, m=1).get_extent())


def test_two_frame_real_image_is_two_frames():
    """A real image with two frames (*scan.shape, 2): the port shows frame
    0; the JAX package joins the two frames as a real/imaginary pair and
    shows |frame 0 + 1j frame 1| (ROADMAP Queue 3). With ri=True the port
    joins them as the JAX package does."""
    scan = qt.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 24), z=np.linspace(10e-3, 20e-3, 20))
    rng = np.random.default_rng(6)
    b = rng.standard_normal(tuple(scan.shape) + (2,)).astype(np.float32)
    h = display.scan_imagesc(scan, b, dbr=None)
    np.testing.assert_allclose(np.asarray(h.get_array()), np.abs(b[:, :, 0, 0]), rtol=1e-6)
    jscan = q.ScanCartesian(x=scan.x, z=scan.z)
    hj = jdisplay.scan_imagesc(jscan, b, dbr=None)
    np.testing.assert_allclose(np.asarray(hj.get_array()),
                               np.abs(b[:, :, 0, 0] + 1j * b[:, :, 0, 1]), rtol=1e-6)
    same_artist(display.scan_imagesc(scan, b, dbr=None, ri=True), hj, db=False)
    same_artist(display.scan_imagesc(scan, b, dbr=None, ri=False),
                jdisplay.scan_imagesc(jscan, b, dbr=None, ri=False), db=False)


SCANS = {
    "cartesian": lambda m: m.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 20),
                                           z=np.linspace(5e-3, 20e-3, 30)),
    "cartesian XZ order": lambda m: m.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 20),
                                                    z=np.linspace(5e-3, 20e-3, 30), order="XZY"),
    "polar": lambda m: m.ScanPolar(r=np.linspace(1e-3, 20e-3, 40), a=np.linspace(-30, 30, 25)),
    "volume": lambda m: _vol_scan(m),
}


@pytest.mark.parametrize("dbr", [60.0, None], ids=["db", "linear"])
@pytest.mark.parametrize("name", list(SCANS))
def test_scan_imagesc_parity(name, dbr):
    """Cartesian (both orders), polar (scan-converted) and a volume's slices,
    complex images and tensors, dB and linear."""
    ref_scan, scan = SCANS[name](q), SCANS[name](qt)
    rng = np.random.default_rng(7)
    b = (rng.standard_normal(scan.shape) + 1j * rng.standard_normal(scan.shape) + 0.2
         ).astype(np.complex64)
    kws = [dict(slice=s, index=1) for s in ("y", "x", "z")] if name == "volume" else [{}]
    for kw in kws:
        same_artist(display.scan_imagesc(scan, torch.from_numpy(b), dbr=dbr, **kw),
                    jdisplay.scan_imagesc(ref_scan, b, dbr=dbr, **kw), db=dbr is not None)


@pytest.mark.parametrize("mode", ["mip", "alpha"])
def test_scan_vol3d_parity(mode):
    scan, ref_scan = _vol_scan(qt), _vol_scan(q)
    vol = np.random.default_rng(8).random(scan.shape).astype(np.float32) + 0.05
    got = display.scan_vol3d(scan, torch.from_numpy(vol), mode=mode)
    ref = jdisplay.scan_vol3d(ref_scan, vol, mode=mode)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g.get_array()), np.asarray(r.get_array()),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.get_extent(), r.get_extent(), rtol=1e-7)
        np.testing.assert_allclose(np.asarray(g.get_alpha() if g.get_alpha() is not None
                                              else 1.0),
                                   np.asarray(r.get_alpha() if r.get_alpha() is not None
                                              else 1.0), rtol=0, atol=1e-5)


def test_image_gif_and_medium_parity():
    """image_gif's first and last frames, and medium_imagesc's map."""
    scan, ref_scan = SCANS["cartesian"](qt), SCANS["cartesian"](q)
    fr = np.random.default_rng(9).random(tuple(scan.shape) + (3,)).astype(np.float32) + 0.1
    got, ref = display.image_gif(scan, torch.from_numpy(fr)), jdisplay.image_gif(ref_scan, fr)
    for i in (0, 2):
        (hg,), (hr,) = got._func(i), ref._func(i)
        np.testing.assert_allclose(np.asarray(hg.get_array()), np.asarray(hr.get_array()),
                                   rtol=0, atol=1e-4)
    reg = ((lambda P: P[2] > 12e-3, {"c": 1600.0}),)
    same_artist(display.medium_imagesc(qt.Medium(c0=1540.0, pertreg=reg), scan),
                jdisplay.medium_imagesc(q.Medium(c0=1540.0, pertreg=reg), ref_scan), db=False)


def test_plots_parity():
    """xdc_plot, scat_plot and scan_plot draw the same points."""
    for got, ref in (
            (display.xdc_plot(qt.TransducerConvex.C5_2v()),
             jdisplay.xdc_plot(q.TransducerConvex.C5_2v())),
            (display.scat_plot(qt.Scatterers(pos=np.array([[0, 1e-3], [0, 0], [5e-3, 8e-3]]))),
             jdisplay.scat_plot(q.Scatterers(pos=np.array([[0, 1e-3], [0, 0], [5e-3, 8e-3]])))),
            (display.scan_plot(SCANS["polar"](qt)), jdisplay.scan_plot(SCANS["polar"](q)))):
        np.testing.assert_array_equal(np.asarray(got.get_xydata()), np.asarray(ref.get_xydata()))


# ------------------------------------------------------------------- demo
def test_demo_main(tmp_path, monkeypatch):
    """The ported demo on device="cpu", its system cut to 32 elements and
    64 x 64 pixels: every image's peak on a target (main checks it), the two
    PNGs written, and each image within 1e-4 of the peak of the JAX
    package's call on the same system and traces."""
    from qups_tpu_torch.examples import demo_imaging as demo

    def small(m):
        L = m.TransducerArray.L11_5v()
        xdc = m.TransducerArray(numel=32, pitch=L.pitch, fc=L.fc, width=L.width,
                                height=L.height)
        seq = m.SequenceRadial(type="PW", angles=np.arange(-10, 11, 5), c0=1540.0)
        scan = m.ScanCartesian(x=np.linspace(-12e-3, 12e-3, 64),
                               z=np.linspace(15e-3, 35e-3, 64))
        return m.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=4 * xdc.fc)

    monkeypatch.setattr(demo, "system", lambda: small(qt))
    out = demo.main(device="cpu", out_dir=str(tmp_path))
    for f in out["figures"]:
        assert f.startswith(str(tmp_path)) and (tmp_path / f.split("/")[-1]).stat().st_size > 0
    chd = out["chd"]
    assert chd.data.device.type == "cpu" and chd.M == 5
    us = small(q)
    ref_chd = q.ChannelData(data=chd.data.numpy(), fs=chd.fs, t0=chd.t0)
    refs = {"DAS": us.DAS(ref_chd), "bfDAS": us.bfDAS(ref_chd),
            "bfAdjoint": us.bfAdjoint(ref_chd), "coherence": us.coherence_image(ref_chd)}
    for name, b in out["images"].items():
        ref = np.asarray(refs[name])
        got = b.numpy()
        assert got.shape == ref.shape, name
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err < TOL_DEMO.get(name, 1e-4), (name, err)


# bfAdjoint on the CPU is the JAX package's XLA engine, whose direct cexp
# phases differ from the port's 2 pi frac(f tau) phasors by up to ~3e-4 rad:
# tests/test_torch_fdbf.py holds the system's bfAdjoint to it at 2e-3.
TOL_DEMO = {"bfAdjoint": 2e-3}
