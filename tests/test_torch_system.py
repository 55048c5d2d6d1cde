"""The slices as a whole: the same small system through
UltrasoundSystem.greens → DAS in qups_tpu and in qups_tpu_torch (with the
splat, which 'auto' picks on the CPU, and with the frequency-domain engine,
which 'auto' picks on a CUDA card), the point-spread-function check,
transmit streaming (bsize), the plane-wave demo flow greens → focusTx →
DAS / bfDAS / bfAdjoint, the docstring examples (the simulator family's
among them; its comparisons with qups_tpu are in test_torch_simus.py and
test_torch_greens_tiled.py), and what raises on the CPU (on a CUDA card:
test_torch_cuda.py)."""
import inspect
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402

TARGET = np.array([0.0, 0.0, 20e-3])
ROOT = Path(__file__).resolve().parents[1]


def _systems(seq=None):
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=seq or q.Sequence(type="FSA", numpulse=16),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 32),
                             z=np.linspace(16e-3, 24e-3, 32)))
    scat = q.Scatterers(pos=TARGET[:, None], c0=1540.0)
    return us, from_reference(us), scat, from_reference(scat)


@pytest.fixture(scope="module")
def fsa():
    us, ust, scat, scatt = _systems()
    chd = us.greens(scat)
    b = np.asarray(us.DAS(chd))
    chdt = ust.greens(scatt, device="cpu")
    return dict(us=us, ust=ust, chd=chd, b=b, chdt=chdt, bt=ust.DAS(chdt),
                scatt=scatt)


def test_slice_traces_match_reference(fsa):
    ref, got = np.asarray(fsa["chd"].data), fsa["chdt"].data.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert fsa["chdt"].t0 == fsa["chd"].t0
    # 2e-4, not 1e-4: XLA rounds the float32 delays (in seconds) with fused
    # multiply-adds and the port does not; an ulp of a 26 us delay is 1.8
    # ps, 3.4e-5 rad of carrier phase at 3 MHz, and a few such terms meet
    # at the peak (measured: 8.0e-5 of the peak).
    assert np.abs(got - ref).max() < 2e-4 * np.abs(ref).max()


def test_slice_image_matches_reference(fsa):
    ref, got = fsa["b"], fsa["bt"].numpy()
    assert got.shape == ref.shape == tuple(fsa["us"].scan.shape) + (1, 1)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def test_slice_freq_engine_matches_reference():
    """greens(impl='freq') → DAS in both packages: the path that 'auto'
    takes on a CUDA card (K3, then K1), here through the plain versions."""
    us, ust, scat, scatt = _systems()
    chd = us.greens(scat, impl="freq")
    chdt = ust.greens(scatt, impl="freq", device="cpu")
    ref, got = np.asarray(chd.data), chdt.data.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert chdt.t0 == chd.t0
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
    bref, b = np.asarray(us.DAS(chd)), ust.DAS(chdt).numpy()
    assert np.abs(b - bref).max() < 1e-4 * np.abs(bref).max()
    P = ust.scan.positions().reshape(3, -1)
    assert np.linalg.norm(P[:, int(np.abs(b).reshape(-1).argmax())] - TARGET) < 1.1e-3


def test_slice_psf(fsa):
    """The BFTest physics oracle: the image peak lies within 1.1 mm of the
    scatterer."""
    img = fsa["bt"].abs().reshape(-1).numpy()
    P = fsa["ust"].scan.positions().reshape(3, -1)
    assert np.linalg.norm(P[:, int(img.argmax())] - TARGET) < 1.1e-3


@pytest.mark.parametrize("keep_tx", [False, True])
def test_bsize_streaming(fsa, keep_tx):
    ust, chdt = fsa["ust"], fsa["chdt"]
    full = ust.DAS(chdt, keep_tx=keep_tx)
    streamed = ust.DAS(chdt, keep_tx=keep_tx, bsize=5)
    assert streamed.shape == full.shape
    assert float((streamed - full).abs().max()) < 1e-4 * float(full.abs().max())


def test_plane_wave_das_matches_reference():
    """Plane-wave data simulated by qups_tpu, beamformed by both packages
    (the port's own plane-wave simulation: test_torch_focus.py)."""
    seq = q.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]), c0=1540.0)
    us, ust, scat, _ = _systems(seq)
    chd = us.greens(scat)
    ref = np.asarray(us.DAS(chd, method="linear"))
    got = ust.DAS(from_reference(chd), method="linear").numpy()
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def test_scope_raises_on_cpu(fsa):
    ust, chdt, scatt = fsa["ust"], fsa["chdt"], fsa["scatt"]
    with pytest.raises(ValueError, match="CUDA"):
        ust.DAS(chdt, kernel="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ust.greens(scatt, impl="pallas", kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ust.greens(scatt, impl="freq", kernel="cuda", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chdt.sample(chdt.time, method="freq")
    with pytest.raises(ValueError, match="CUDA"):
        ust.bfDASLUT(chdt, *ust.das_delay_tables(device="cpu"), kernel="cuda")
    with pytest.raises(NotImplementedError, match="cubic2x"):
        ust.DAS(chdt, method="cubic2x")
    with pytest.raises(NotImplementedError, match="K1\\(d\\)"):
        ust.DAS(chdt, apod=qt.Fused("aperture_growth", f=1.5))


@pytest.mark.parametrize("entry", ["greens", "simus", "calc_scat_all", "calc_scat_multi",
                                   "calc_hp", "das_delay_tables", "ops.delay_tables",
                                   "ops.geom_delays"])
def test_simulators_default_to_the_card(fsa, entry):
    """The simulators, and the delay ops behind das_delay_tables, calc_hp and
    bfAdjoint, run on the CUDA device unless the caller names another: with a
    card their result is a CUDA tensor; without one the call raises instead
    of returning CPU traces."""
    ust, scatt = fsa["ust"], fsa["scatt"]
    pi, pe = ust._pixels(), ust.rx.positions().T
    pv, nv, model = ust._tx_geometry()
    calls = {"greens": lambda: ust.greens(scatt).data,
             "simus": lambda: ust.simus(scatt).data,
             "calc_scat_all": lambda: ust.calc_scat_all(scatt).data,
             "calc_scat_multi": lambda: ust.calc_scat_multi(scatt).data,
             "calc_hp": lambda: ust.calc_hp(),
             "das_delay_tables": lambda: ust.das_delay_tables()[0],
             "ops.delay_tables": lambda: qt.ops.delay_tables(pi, pe, pv, nv, 1540.0,
                                                             model)[0],
             "ops.geom_delays": lambda: qt.ops.fdbf.geom_delays(pi, pe, np.float32(1 / 1540.0))}
    if torch.cuda.is_available():
        assert calls[entry]().is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            calls[entry]()


def test_demo_flow_end_to_end():
    """examples/demo_imaging.py's flow at a reduced size (its L11-5v cut to
    16 elements, 3 plane waves, 32 x 32 pixels, its 20 point targets):
    greens → focusTx → DAS, bfDAS and bfAdjoint in the port, each image's
    peak within 1.1 mm of a target (the demo's own oracle)."""
    L = qt.TransducerArray.L11_5v()
    xdc = qt.TransducerArray(numel=16, pitch=L.pitch, fc=L.fc)
    seq = qt.SequenceRadial(type="PW", angles=np.array([-10.0, 0.0, 10.0]), c0=1540.0)
    scan = qt.ScanCartesian(x=np.linspace(-12e-3, 12e-3, 32),
                            z=np.linspace(15e-3, 35e-3, 32))
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=4 * xdc.fc)
    Zs, Xs = np.meshgrid(np.linspace(18e-3, 32e-3, 4), np.linspace(-8e-3, 8e-3, 5),
                         indexing="ij")
    pos = np.stack([Xs.ravel(), np.zeros(Xs.size), Zs.ravel()])
    chd = us.greens(qt.Scatterers(pos=pos, amp=np.ones(pos.shape[1]), c0=1540.0),
                    device="cpu")
    assert chd.M == 3
    P = scan.positions().reshape(3, -1)
    for name, b in (("DAS", us.DAS(chd)), ("bfDAS", us.bfDAS(chd)),
                    ("bfAdjoint", us.bfAdjoint(chd))):
        assert b.shape == tuple(scan.shape) + (1, 1) and bool(torch.isfinite(b).all())
        k = int(b.abs().reshape(-1).argmax())
        d = np.linalg.norm(pos - P[:, k:k + 1], axis=0).min()
        assert d < 1.1e-3, (name, d)


def _port_docs():
    """The port's README block (fenced ``py``) and its docstring examples."""
    text = (ROOT / "README.md").read_text()
    out = [("README.md", b) for b in re.findall(r"```py\n(.*?)```", text, re.S)]
    for obj in (qt.UltrasoundSystem.greens, qt.UltrasoundSystem.DAS,
                qt.UltrasoundSystem.focusTx, qt.UltrasoundSystem.bfDAS,
                qt.UltrasoundSystem.bfDASLUT, qt.UltrasoundSystem.bfAdjoint,
                qt.UltrasoundSystem.simus, qt.UltrasoundSystem.calc_scat_multi,
                qt.UltrasoundSystem.calc_hp, from_reference):
        ex = inspect.getdoc(obj).split("Example:", 1)[1]
        out.append((obj.__qualname__, textwrap.dedent(ex)))
    return out


@pytest.mark.parametrize("name,code", _port_docs(), ids=lambda v: v[:24])
def test_port_docs_run(name, code):
    exec(compile(code, name, "exec"), {})
