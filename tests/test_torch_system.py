"""The slices as a whole: the same small system through
UltrasoundSystem.greens → DAS in qups_tpu and in qups_tpu_torch (with the
splat, which 'auto' picks on the CPU, and with the frequency-domain engine,
which 'auto' picks on a CUDA card), the point-spread-function check,
transmit streaming (bsize), the plane-wave demo flow greens → focusTx →
DAS / bfDAS / bfAdjoint, the IQ ensemble flow (frames joined, hilbert,
downmix, resample, then the beamformers with fmod) and the cheat sheet's
DSP block, the docstring examples (the simulator family's
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
    return dict(us=us, ust=ust, chd=chd, b=b, chdt=chdt, bt=ust.DAS(chdt, device="cpu"),
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
    bref, b = np.asarray(us.DAS(chd)), ust.DAS(chdt, device="cpu").numpy()
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
    full = ust.DAS(chdt, keep_tx=keep_tx, device="cpu")
    streamed = ust.DAS(chdt, keep_tx=keep_tx, bsize=5, device="cpu")
    assert streamed.shape == full.shape
    assert float((streamed - full).abs().max()) < 1e-4 * float(full.abs().max())


def test_plane_wave_das_matches_reference():
    """Plane-wave data simulated by qups_tpu, beamformed by both packages
    (the port's own plane-wave simulation: test_torch_focus.py)."""
    seq = q.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]), c0=1540.0)
    us, ust, scat, _ = _systems(seq)
    chd = us.greens(scat)
    ref = np.asarray(us.DAS(chd, method="linear"))
    got = ust.DAS(from_reference(chd), method="linear", device="cpu").numpy()
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def test_scope_raises_on_cpu(fsa):
    """What raises with device="cpu" (kernel='cuda'), and what no longer
    does: ``sample(method='freq')``, ``method='cubic2x'`` and Fused
    apodization (materialized, as the JAX package's XLA path) run on the
    CPU, against the JAX package."""
    us, chd, ust, chdt, scatt = fsa["us"], fsa["chd"], fsa["ust"], fsa["chdt"], fsa["scatt"]
    with pytest.raises(ValueError, match="CUDA"):
        ust.DAS(chdt, kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ust.greens(scatt, impl="pallas", kernel="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ust.greens(scatt, impl="freq", kernel="cuda", device="cpu")
    tau = chdt.time[::7, :1, :3] + 1e-7
    got = chdt.sample(tau, method="freq").numpy()
    ref = np.asarray(chd.sample(tau.numpy(), method="freq"))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
    with pytest.raises(ValueError, match="CUDA"):
        ust.bfDASLUT(chdt, *ust.das_delay_tables(device="cpu"), kernel="cuda", device="cpu")
    got = ust.DAS(chdt, method="cubic2x", device="cpu").numpy()
    ref = np.asarray(us.DAS(chd, method="cubic2x"))
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
    got = ust.DAS(chdt, apod=qt.Fused("aperture_growth", f=1.5), device="cpu").numpy()
    ref = np.asarray(us.DAS(chd, apod=q.Fused("aperture_growth", f=1.5)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("entry", ["greens", "simus", "calc_scat_all", "calc_scat_multi",
                                   "calc_hp", "das_delay_tables", "ops.delay_tables",
                                   "ops.geom_delays", "DAS", "bfDAS", "bfDASLUT",
                                   "bfAdjoint", "focusTx"])
def test_simulators_default_to_the_card(fsa, entry):
    """The simulators, the delay ops behind das_delay_tables, calc_hp and
    bfAdjoint, and the beamformers and focusTx, run on the CUDA device unless
    the caller names another: with a card their result is a CUDA tensor
    (CPU traces move there); without one the call raises, naming
    device="cpu", instead of computing on the CPU."""
    ust, scatt, chdt = fsa["ust"], fsa["scatt"], fsa["chdt"]
    assert chdt.data.device.type == "cpu"
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
             "ops.geom_delays": lambda: qt.ops.fdbf.geom_delays(pi, pe, np.float32(1 / 1540.0)),
             "DAS": lambda: ust.DAS(chdt),
             "bfDAS": lambda: ust.bfDAS(chdt),
             "bfDASLUT": lambda: ust.bfDASLUT(chdt, *ust.das_delay_tables(device="cpu")),
             "bfAdjoint": lambda: ust.bfAdjoint(chdt),
             "focusTx": lambda: ust.focusTx(chdt, qt.SequenceRadial(
                 type="PW", angles=[0.0], c0=1540.0)).data}
    if torch.cuda.is_available():
        assert calls[entry]().is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
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
    for name, b in (("DAS", us.DAS(chd, device="cpu")), ("bfDAS", us.bfDAS(chd, device="cpu")),
                    ("bfAdjoint", us.bfAdjoint(chd, device="cpu"))):
        assert b.shape == tuple(scan.shape) + (1, 1) and bool(torch.isfinite(b).all())
        k = int(b.abs().reshape(-1).argmax())
        d = np.linalg.norm(pos - P[:, k:k + 1], axis=0).min()
        assert d < 1.1e-3, (name, d)


def _iq_frames(us, depths):
    """The JAX package's frames, one per depth: greens of a target there,
    with two silent scatterers that give every frame the same time
    window."""
    pad = np.array([[0.0, 0.0], [0.0, 0.0], [14e-3, 26e-3]])
    chds = [us.greens(q.Scatterers(pos=np.concatenate([[[0.0], [0.0], [z]], pad], 1),
                                   amp=np.array([1.0, 0.0, 0.0]), c0=1540.0))
            for z in depths]
    return chds


@pytest.fixture(scope="module")
def iq():
    """The IQ ensemble on a small plane-wave system (F = 2, the target 0.3
    mm deeper in the second frame): the JAX chain, and the port's chain on
    the same greens traces."""
    seq = q.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]), c0=1540.0)
    us, ust, _, _ = _systems(seq)
    depths = (20e-3, 20.3e-3)
    chds = _iq_frames(us, depths)
    ref = chds[0].join(chds[1:]).hilbert().downmix(us.fc).resample(us.fs / 2)
    chdt = [from_reference(c) for c in chds]
    got = chdt[0].join(chdt[1:]).hilbert().downmix(ust.fc).resample(ust.fs / 2)
    return dict(us=us, ust=ust, ref=ref, got=got, depths=depths)


def test_iq_chain_matches_reference(iq):
    """join, hilbert, downmix and resample in the port on the JAX package's
    frames give the JAX package's IQ data (resample samples: 1e-4)."""
    got, ref = iq["got"], iq["ref"]
    assert got.data.shape == ref.data.shape and got.data.shape[3] == 2
    assert got.data.dtype == torch.complex64 and got.fs == ref.fs
    assert np.array_equal(np.asarray(got.t0, np.float64), np.asarray(ref.t0, np.float64))
    ref_d = np.asarray(ref.data)
    assert np.abs(got.data.numpy() - ref_d).max() < 1e-4 * np.abs(ref_d).max()


@pytest.mark.parametrize("call", ["DAS", "bfDAS", "DAS_cubic2x", "DAS_real"])
def test_iq_ensemble_matches_reference(iq, call):
    """The beamformers on the IQ ensemble with fmod = fc (K1(b)'s and K2(b)'s
    path; the plain versions here) against the JAX package on the same IQ
    data, to 1e-4 of the peak, and each frame's peak within 1.1 mm of its
    target; real traces with fmod give a complex image."""
    us, ust, ref_chd = iq["us"], iq["ust"], iq["ref"]
    if call == "DAS_real":
        ref_chd = ref_chd.replace(data=ref_chd.data.real)
    chdt = from_reference(ref_chd)
    kw = dict(method="cubic2x") if call == "DAS_cubic2x" else {}
    fn = "bfDAS" if call == "bfDAS" else "DAS"
    ref = np.asarray(getattr(us, fn)(ref_chd, fmod=us.fc, **kw))
    got = getattr(ust, fn)(chdt, fmod=ust.fc, device="cpu", **kw)
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == ref.shape == tuple(ust.scan.shape) + (1, 1, 2)
    got = got.numpy()
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
    if call != "DAS_real":
        P = ust.scan.positions().reshape(3, -1)
        for f, z in enumerate(iq["depths"]):
            k = int(np.abs(got[..., f]).reshape(-1).argmax())
            assert np.linalg.norm(P[:, k] - [0.0, 0.0, z]) < 1.1e-3, (call, f)


def test_cheat_sheet_dsp_block_runs_in_the_port():
    """examples/cheat_sheet.py's DSP block, as written there, on the port's
    ChannelData (the cheat sheet's plane-wave system and target, simulated by
    the JAX package): the same IQ data as the JAX package's, and the port's
    DAS of it with fmod = fc the JAX package's image."""
    text = (ROOT / "examples" / "cheat_sheet.py").read_text()
    block = text.split("# ----------------------------------------------------------------------- DSP")[1]
    block = block.split("# -----")[0]
    assert "hilbert" in block and "downmix" in block and "resample" in block
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=5e6)
    ang = np.radians([-10.0, 0.0, 10.0])
    seq = q.Sequence(type="PW", focus=np.stack([np.sin(ang), 0 * ang, np.cos(ang)]), c0=1540.0)
    scan = q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 64), y=[0.0],
                           z=np.linspace(12e-3, 24e-3, 64))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=25e6)
    chd = us.greens(q.Scatterers(pos=np.array([[0.0], [0.0], [18e-3]]), c0=1540.0))
    ref, got = {"chd": chd, "us": us}, {"chd": from_reference(chd), "us": from_reference(us)}
    exec(compile(block, "cheat_sheet.py", "exec"), ref)
    exec(compile(block, "cheat_sheet.py", "exec"), got)
    r, g = np.asarray(ref["chd2"].data), got["chd2"].data.numpy()
    assert g.shape == r.shape and got["chd2"].fs == ref["chd2"].fs == 12.5e6
    assert np.abs(g - r).max() < 1e-4 * np.abs(r).max()
    bref = np.asarray(us.DAS(ref["chd2"], fmod=us.fc))
    b = got["us"].DAS(got["chd2"], fmod=us.fc, device="cpu").numpy()
    assert np.abs(b - bref).max() < 1e-4 * np.abs(bref).max()


def _port_docs():
    """The port's README block (fenced ``py``) and its docstring examples."""
    text = (ROOT / "README.md").read_text()
    out = [("README.md", b) for b in re.findall(r"```py\n(.*?)```", text, re.S)]
    for obj in (qt.UltrasoundSystem.greens, qt.UltrasoundSystem.DAS,
                qt.UltrasoundSystem.focusTx, qt.UltrasoundSystem.bfDAS,
                qt.UltrasoundSystem.bfDASLUT, qt.UltrasoundSystem.bfAdjoint,
                qt.UltrasoundSystem.simus, qt.UltrasoundSystem.calc_scat_multi,
                qt.UltrasoundSystem.calc_hp, qt.UltrasoundSystem.coherence_image,
                from_reference):
        ex = inspect.getdoc(obj).split("Example:", 1)[1]
        out.append((obj.__qualname__, textwrap.dedent(ex)))
    return out


@pytest.mark.parametrize("name,code", _port_docs(), ids=lambda v: v[:24])
def test_port_docs_run(name, code):
    exec(compile(code, name, "exec"), {})
