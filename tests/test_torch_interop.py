"""The port's file import and export (qups_tpu_torch.interop) against
qups_tpu.interop, on the CPU.

Every case of tests/test_interop.py runs on the port (the genuine-UFF case
skips without QUPS_UFF_FIXTURE, as there). Then the parity cases: each
fixture (Verasonics structs and saved workspaces, UFF files in the port's
and in the MATLAB-USTB dialect, .mat files), built from a seed with numpy,
is read by both packages, and the port's objects equal the JAX package's
carried across by ``from_reference``, field by field; the traces are equal
bit for bit; and the DAS image of each loaded acquisition, the port's on
``device="cpu"``, lies within 1e-4 x max|JAX| of the JAX package's (the
float32 standard). Files written by either package load in the other.
UFF cases skip without h5py. The card's import path (a Vantage workspace
beamformed on K1(b)) is in tests/test_torch_cuda.py.
"""
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
from qups_tpu import interop as jinterop  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch import interop  # noqa: E402
from qups_tpu_torch import io as tio  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402

TOL = 1e-4


# ----------------------------------------------------------------- helpers
def _trans_struct(numel=16, fc=5.0):
    pitch_mm = 0.3
    x = (np.arange(numel) - (numel - 1) / 2) * pitch_mm
    pos = np.zeros((numel, 5))
    pos[:, 0] = x
    return dict(name="L-test", units="mm", frequency=fc, numelements=numel,
                elementWidth=0.27, elementLength=5.0, spacingMm=pitch_mm,
                Bandwidth=np.array([3.0, 7.0]), type=0, ElementPos=pos,
                ConnectorES=np.arange(1, numel + 1))


def _records(rows):
    """A list of dicts as a Verasonics struct array (a numpy record array
    of object fields, as savemat writes a struct array)."""
    names = list(rows[0])
    a = np.zeros((len(rows),), dtype=[(n, "O") for n in names])
    for i, r in enumerate(rows):
        a[i] = tuple(r[n] for n in names)
    return a


def _dict(obj):
    """The port object's fields as a plain dict, waveform functions out."""
    return tio.obj2dict(obj)


def _data(d):
    """The dict without its None entries (a waveform's function, dropped by
    obj2dict, comes back from a file as None)."""
    if isinstance(d, dict):
        return {k: _data(v) for k, v in d.items() if v is not None}
    return d


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a.keys(), b.keys())
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, str) or a is None:
        assert a == b, (where, a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def same_obj(got, ref):
    """The port's object equals the JAX package's, carried across, field by
    field (a ChannelData's traces bit for bit)."""
    assert type(got).__name__ == type(ref).__name__
    assert type(got).__module__.startswith("qups_tpu_torch")
    _same(_dict(got), _dict(from_reference(ref)), type(got).__name__)


def same_waveform(got, ref):
    """Equal sample grids and samples (the function itself is code)."""
    assert (got.t0, got.tend, got.fs) == (ref.t0, ref.tend, ref.fs)
    t = ref.t0 + np.arange(int(round((ref.tend - ref.t0) * 250e6)) + 1) / 250e6
    np.testing.assert_array_equal(np.asarray(got.sample(t)), np.asarray(ref.sample(t)))


def same_bundle(got, ref):
    """Two load_* results: the same keys, objects and traces."""
    assert got.keys() == ref.keys(), (got.keys(), ref.keys())
    for k in ref:
        if k == "chd" and isinstance(ref[k], list):
            assert len(got[k]) == len(ref[k])
            for g, r in zip(got[k], ref[k]):
                same_obj(g, r)
                assert g.data.device.type == "cpu"
        elif k in ("chd", "xdc", "seq", "scan"):
            same_obj(got[k], ref[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)


def das_parity(xdc, seq, scan, chd, xdc_r, seq_r, scan_r, chd_r, fmod=0.0, t0=None):
    """The port's DAS of a loaded bundle (device="cpu") against the JAX
    package's of the same file: within 1e-4 x max|JAX|. Returns the port's
    image."""
    if t0 is not None:
        chd, chd_r = chd.replace(t0=t0), chd_r.replace(t0=t0)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=float(chd.fs))
    us_r = q.UltrasoundSystem(tx=xdc_r, rx=xdc_r, seq=seq_r, scan=scan_r, fs=float(chd_r.fs))
    b = us.DAS(chd, fmod=fmod, device="cpu")
    ref = np.asarray(us_r.DAS(chd_r, fmod=fmod))
    got = b.numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < TOL, err
    return b


def _psf(b, scan, target):
    """The image's peak lies within 1.1 mm of the target."""
    img = b.abs().reshape(-1).numpy()
    P = scan.positions().reshape(3, -1)
    assert np.linalg.norm(P[:, int(img.argmax())] - target) < 1.1e-3


# ------------------------------------------- the cases of tests/test_interop.py
def test_transducer_from_verasonics():
    numel = 16
    xdc = interop.transducer_from_verasonics(_trans_struct(numel))
    assert isinstance(xdc, qt.TransducerArray)
    assert xdc.numel == numel
    assert np.isclose(xdc.pitch, 0.3e-3)
    assert np.isclose(xdc.fc, 5e6)
    assert np.isclose(xdc.bw[0], 3e6) and np.isclose(xdc.bw[1], 7e6)
    p = xdc.positions()
    assert np.isclose(p[0].max() - p[0].min(), 0.3e-3 * (numel - 1))


def _pw_tx(Trans, angs):
    """PW TX structs with Vantage-convention delays from the geometry
    (Vantage delays are -qups delays + an offset, in wavelengths)."""
    TX = [dict(Apod=np.ones(16), Steer=np.array([a, 0.0]), focus=0.0,
               Origin=np.zeros(3), Delay=np.zeros(16)) for a in angs]
    xdc = interop.transducer_from_verasonics(Trans)
    fc = 5e6
    for t, a in zip(TX, angs):
        seqa = qt.Sequence(type="PW", focus=np.array([[np.sin(a)], [0.0], [np.cos(a)]]),
                           c0=1540.0)
        tau = seqa.delays(xdc)[:, 0]
        t["Delay"] = (-tau + tau.max()) * fc  # nonneg, wavelength units
    return TX


def test_sequence_from_verasonics_pw():
    Trans = _trans_struct()
    angs = np.radians([-10.0, 0.0, 10.0])
    seq, t0 = interop.sequence_from_verasonics(_pw_tx(Trans, angs), Trans)
    assert seq.type == "PW"
    assert seq.num_pulse == 3
    f = seq.focus_array
    got = np.degrees(np.arctan2(f[0], f[2]))
    assert np.allclose(got, [-10, 0, 10], atol=1e-3)
    assert np.all(np.isfinite(t0))  # delays verified to an offset


def test_sequence_from_verasonics_fsa():
    Trans = _trans_struct()
    TX = [dict(Apod=(np.arange(16) == i).astype(float),
               Steer=np.zeros(2), focus=0.0, Origin=np.zeros(3),
               Delay=np.zeros(16)) for i in range(16)]
    seq, _ = interop.sequence_from_verasonics(TX, Trans)
    assert seq.type == "FSA"
    assert seq.num_pulse == 16


def _receive(numel, A, T, F, fs=25.0, fmod=0.0, mode="NS200BW", **extra):
    return [dict(bufnum=1, framenum=f, acqNum=a, startSample=(a - 1) * T + 1,
                 endSample=a * T, decimSampleRate=fs, demodFrequency=fmod,
                 sampleMode=mode, Apod=np.ones(numel), **extra)
            for f in range(1, F + 1) for a in range(1, A + 1)]


def test_channel_data_from_verasonics():
    numel, A, T, F = 8, 4, 64, 2
    rng = np.random.default_rng(0)
    buf = rng.integers(-100, 100, (T * A, numel, F)).astype(np.int16)
    chds, fmods, smodes = interop.channel_data_from_verasonics(
        [buf], _receive(numel, A, T, F), Trans=_trans_struct(numel))
    chd = chds[0]
    assert chd.data.shape == (T, numel, A, F)
    assert isinstance(chd.data, torch.Tensor) and chd.data.device.type == "cpu"
    assert np.isclose(chd.fs, 25e6)
    # spot-check a sample mapping: acq a, channel n, frame f
    assert np.allclose(chd.data.numpy()[:, 3, 2, 1], buf[2 * T:3 * T, 3, 1])


def test_channel_data_sample_mode_zeros():
    numel, A, T = 4, 1, 32
    buf = np.ones((T, numel, 1), np.int16)
    Receive = [dict(bufnum=1, framenum=1, acqNum=1, startSample=1,
                    endSample=T, decimSampleRate=10.0, demodFrequency=2.0,
                    sampleMode="BS100BW", Apod=np.ones(numel))]
    chds, fmods, _ = interop.channel_data_from_verasonics([buf], Receive)
    x = chds[0].data.numpy()
    # [1,1,0,0] pattern: 2 zeros inserted every 2 samples
    assert x.shape[0] == 2 * T
    assert np.all(x[0::4] == 1) and np.all(x[1::4] == 1)
    assert np.all(x[2::4] == 0) and np.all(x[3::4] == 0)
    assert np.isclose(fmods[0], 2e6)


def test_scan_from_verasonics():
    PData = dict(Coord="rectangular", Size=np.array([64, 128, 1]),
                 PDelta=np.array([0.5, 0.0, 0.25]),
                 Origin=np.array([-32.0, 0.0, 0.0]))
    scan = interop.scan_from_verasonics(PData, scale=1e-3)
    assert isinstance(scan, qt.ScanCartesian)
    assert scan.nx == 128 and scan.nz == 64
    assert np.isclose(scan.dx, 0.5e-3) and np.isclose(scan.dz, 0.25e-3)


def _tw():
    t = np.arange(100)
    tri = np.where((t > 20) & (t < 80), np.sign(np.sin(2 * np.pi * t / 20)), 0.0)
    return dict(Parameters=np.array([5.0, 0.67, 2, 1]), peak=1.0, numsamples=100,
                TriLvlWvfm=tri, Wvfm1Wy=tri * 0.5, Wvfm2Wy=tri * 0.25), tri


def test_waveform_from_verasonics():
    TW, tri = _tw()
    wv = interop.waveform_from_verasonics(TW)
    s = np.asarray(wv.sample(wv.t0 + np.arange(100) / 250e6))
    assert np.allclose(s, tri, atol=1e-6)


def _uff_bundle(m):
    rng = np.random.default_rng(1)
    xdc = m.TransducerArray(numel=8, pitch=0.4e-3, fc=6e6)
    seq = m.Sequence(type="PW", focus=np.array([[0.0, 0.1], [0, 0], [1.0, 0.99]]), c0=1500.0)
    scan = m.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 32), y=[0.0],
                           z=np.linspace(0, 20e-3, 64))
    chd = m.ChannelData(
        data=(rng.standard_normal((48, 8, 2))
              + 1j * rng.standard_normal((48, 8, 2))).astype(np.complex64),
        fs=20e6, t0=np.array([1e-6, 2e-6]))
    return dict(chd=chd, xdc=xdc, seq=seq, scan=scan)


def test_uff_round_trip(tmp_path):
    pytest.importorskip("h5py")
    bnd = _uff_bundle(qt)
    chd, xdc, seq, scan = bnd["chd"], bnd["xdc"], bnd["seq"], bnd["scan"]
    p = tmp_path / "t.uff"
    interop.save_uff(p, chd=chd, xdc=xdc, seq=seq, scan=scan)
    out = interop.load_uff(p)
    assert torch.equal(out["chd"].data, chd.data)
    assert np.isclose(out["chd"].fs, chd.fs)
    assert np.allclose(out["chd"].t0_host, chd.t0_host)
    assert isinstance(out["xdc"], qt.TransducerArray)
    assert np.isclose(out["xdc"].pitch, xdc.pitch)
    assert out["xdc"].numel == xdc.numel
    assert out["seq"].type == "PW"
    assert np.allclose(out["seq"].focus_array, seq.focus_array)
    assert np.allclose(out["scan"].x, scan.x)
    assert np.allclose(out["scan"].z, scan.z)


def test_mat_round_trip(tmp_path):
    xdc = qt.TransducerConvex(numel=12, radius=40e-3, fc=3e6)
    scan = qt.ScanPolar(origin=(0, 0, -1e-3), r=np.linspace(0, 30e-3, 64),
                        a=np.linspace(-30, 30, 32))
    p = tmp_path / "t.mat"
    interop.save_mat(p, xdc=xdc, scan=scan)
    out = interop.load_mat(p)
    assert isinstance(out["xdc"], qt.TransducerConvex)
    assert np.isclose(out["xdc"].radius, 40e-3)
    assert out["xdc"].numel == 12
    assert isinstance(out["scan"], qt.ScanPolar)
    assert np.allclose(out["scan"].r, scan.r)


def _workspace(numel=8, A=3, T=32, seed=2):
    """tests/test_interop.py's synthetic Vantage workspace."""
    rng = np.random.default_rng(seed)
    Trans = _trans_struct(numel)
    Receive = _records([dict(bufnum=1, framenum=1, acqNum=a + 1, startSample=a * T + 1,
                             endSample=(a + 1) * T, decimSampleRate=20.0, demodFrequency=0.0,
                             sampleMode="NS200BW", Apod=np.ones(numel)) for a in range(A)])
    TX = _records([dict(Apod=np.ones(numel), Steer=np.array([a, 0.0]), focus=0.0,
                        Origin=np.zeros(3), Delay=np.zeros(numel))
                   for a in np.radians([-5.0, 0.0, 5.0])])
    ws = dict(Trans=Trans, Receive=Receive, TX=TX, RcvData=np.empty((1,), object),
              Resource=dict(Parameters=dict(speedOfSound=1540.0)))
    ws["RcvData"][0] = rng.integers(-50, 50, (T * A, numel, 1)).astype(np.int16)
    return ws


def test_load_verasonics_workspace(tmp_path):
    """End-to-end: save a synthetic Vantage workspace .mat, import it."""
    from scipy.io import savemat
    numel, A, T = 8, 3, 32
    p = tmp_path / "ws.mat"
    savemat(p, _workspace(numel, A, T), long_field_names=True)
    out = interop.load_verasonics(p)
    assert isinstance(out["xdc"], qt.TransducerArray)
    assert out["seq"].type in ("PW", "FSA")
    assert out["chd"][0].data.shape == (T, numel, A, 1)


def _chararr(s):
    return np.array([ord(c) for c in s], np.uint16)


def _write_ustb(path, data, angles, pitch=0.3e-3, fc=5e6, c0=1540.0, fs=20e6, it0=2e-6,
                fmod=None, scan=None):
    """A file in MATLAB USTB conventions: char-code class attributes,
    column-major (reversed-axis) data, a complex group for complex data,
    uff.wave sequence children with plane uff.point sources, a
    linear_array probe, optionally a linear_scan."""
    import h5py
    N = data.shape[1]
    with h5py.File(path, "w") as f:
        f.attrs["version"] = _chararr("v1.2.0")
        g = f.create_group("channel_data")
        g.attrs["class"] = _chararr("uff.channel_data")
        if np.iscomplexobj(data):
            dg = g.create_group("data")
            dg.attrs["complex"] = np.int16(1)
            dg.create_dataset("real", data=np.transpose(data.real))
            dg.create_dataset("imag", data=np.transpose(data.imag))
        else:
            g.create_dataset("data", data=np.transpose(data))
        g.create_dataset("sampling_frequency", data=np.float64(fs))
        g.create_dataset("initial_time", data=np.float64(it0))
        g.create_dataset("sound_speed", data=np.float64(c0))
        if fmod is not None:
            g.create_dataset("modulation_frequency", data=np.float64(fmod))
        pu = g.create_group("pulse")
        pu.attrs["class"] = _chararr("uff.pulse")
        pu.create_dataset("center_frequency", data=np.float64(fc))
        pg = g.create_group("probe")
        pg.attrs["class"] = _chararr("uff.linear_array")
        xs = (np.arange(N) - (N - 1) / 2) * pitch
        geom = np.stack([xs, np.zeros(N), np.zeros(N), np.zeros(N),
                         np.zeros(N), np.full(N, 0.27e-3), np.full(N, 5e-3)])
        pg.create_dataset("geometry", data=geom)
        pg.create_dataset("pitch", data=np.float64(pitch))
        pg.create_dataset("N", data=np.float64(N))
        sg = g.create_group("sequence")
        sg.attrs["array"] = _chararr("1")
        for i, a in enumerate(angles):
            w = sg.create_group(f"sequence_{i + 1:04d}")
            w.attrs["class"] = _chararr("uff.wave")
            w.create_dataset("wavefront", data=np.int32(0))  # plane
            w.create_dataset("delay", data=np.float64(0.0))
            sp = w.create_group("source")
            sp.attrs["class"] = _chararr("uff.point")
            sp.create_dataset("azimuth", data=np.float64(a))
            sp.create_dataset("elevation", data=np.float64(0.0))
            sp.create_dataset("distance", data=np.float64(np.inf))
        if scan is not None:
            cg = g.create_group("scan")
            cg.attrs["class"] = _chararr("uff.linear_scan")
            cg.create_dataset("x_axis", data=np.asarray(scan.x, np.float64))
            cg.create_dataset("y_axis", data=np.zeros(1))
            cg.create_dataset("z_axis", data=np.asarray(scan.z, np.float64))


def test_load_uff_ustb_dialect(tmp_path):
    """Read a synthetic file in MATLAB USTB conventions (mapping per
    ``src/ChannelData.m:180-240``, ``src/Sequence.m:540-612``)."""
    pytest.importorskip("h5py")
    path = tmp_path / "ustb.uff"
    T, N, M = 32, 8, 3
    data = np.random.default_rng(3).standard_normal((T, N, M)).astype(np.float32)
    angles = np.radians([-10.0, 0.0, 10.0])
    _write_ustb(path, data, angles)
    out = interop.load_uff(path)
    chd, xdc, seq = out["chd"], out["xdc"], out["seq"]
    assert chd.data.shape == (T, N, M)
    assert np.allclose(chd.data.numpy(), data)
    assert float(chd.fs) == 20e6
    # zero wave delays -> t0 from initial_time
    assert np.allclose(np.asarray(chd.t0_host).reshape(-1), 2e-6)
    assert isinstance(xdc, qt.TransducerArray)
    assert xdc.numel == N and np.isclose(xdc.pitch, 0.3e-3)
    assert np.isclose(xdc.fc, 5e6)  # from the pulse center frequency
    assert seq.type == "PW"
    nv = seq.focus_array  # (3, M) unit directions
    assert np.allclose(nv[0], np.sin(angles), atol=1e-6)
    assert np.allclose(nv[2], np.cos(angles), atol=1e-6)


def _picmus_like(path):
    """A plane-wave IQ acquisition written in the MATLAB-USTB layout: the
    JAX package's greens of a point target at 20 mm, downmixed. Returns the
    IQ traces, the target and the scan."""
    c0, fc = 1540.0, 3e6
    target = np.array([0.0, 0.0, 20e-3])
    angles = np.radians([-5.0, 0.0, 5.0])
    xdc = q.TransducerArray(numel=32, pitch=0.3e-3, fc=fc)
    seq = q.SequenceRadial(type="PW", angles=np.degrees(angles), c0=c0)
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 41), z=np.linspace(16e-3, 24e-3, 41))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=24e6)
    chd = us.greens(q.Scatterers(pos=target.reshape(3, 1), c0=c0))
    data = np.asarray(chd.downmix(fc).data)
    t0 = float(np.asarray(chd.t0_host).reshape(-1)[0])
    _write_ustb(path, data, angles, fc=fc, c0=c0, fs=us.fs, it0=t0, fmod=fc, scan=scan)
    return data, target


def test_load_uff_ustb_picmus_iq_end_to_end(tmp_path):
    """PICMUS-convention IQ file -> (chd, xdc, seq, scan, fmod) -> the port's
    DAS on device="cpu" -> the PSF at the target."""
    pytest.importorskip("h5py")
    path = tmp_path / "picmus_like.uff"
    data, target = _picmus_like(path)
    out = interop.load_uff(path)
    assert out["fmod"] == 3e6
    chd2, xdc2, seq2, scan2 = out["chd"], out["xdc"], out["seq"], out["scan"]
    assert chd2.data.is_complex()
    assert np.allclose(chd2.data.numpy(), data, atol=1e-6)
    assert isinstance(scan2, qt.ScanCartesian) and scan2.shape[:2] == (41, 41)
    us2 = qt.UltrasoundSystem(tx=xdc2, rx=xdc2, seq=seq2, scan=scan2, fs=float(chd2.fs))
    b = us2.DAS(chd2, fmod=out["fmod"], device="cpu").abs().squeeze().numpy()
    i, j = np.unravel_index(np.argmax(b), b.shape)
    P = us2.scan.positions()
    assert abs(P[0, i, j, 0] - target[0]) < 1.1e-3
    assert abs(P[2, i, j, 0] - target[2]) < 1.1e-3


def _write_vs(path, foci, c0=1540.0):
    import h5py
    M = foci.shape[1]
    with h5py.File(path, "w") as f:
        f.attrs["version"] = _chararr("v1.2.0")
        g = f.create_group("channel_data")
        g.attrs["class"] = _chararr("uff.channel_data")
        g.create_dataset("data", data=np.zeros((M, 4, 16)))  # (M,N,T) reversed
        g.create_dataset("sampling_frequency", data=np.float64(10e6))
        g.create_dataset("sound_speed", data=np.float64(c0))
        sg = g.create_group("sequence")
        for i in range(M):
            w = sg.create_group(f"sequence_{i + 1:04d}")
            w.attrs["class"] = _chararr("uff.wave")
            w.create_dataset("wavefront", data=np.int32(1))  # spherical
            w.create_dataset("delay", data=np.float64(1e-6))
            sp = w.create_group("source")
            sp.attrs["class"] = _chararr("uff.point")
            sp.create_dataset("azimuth", data=np.float64(np.arctan2(foci[0, i], foci[2, i])))
            sp.create_dataset("elevation", data=np.float64(0.0))
            sp.create_dataset("distance", data=np.float64(np.linalg.norm(foci[:, i])))


FOCI = np.stack([np.linspace(-2e-3, 2e-3, 3), np.zeros(3), np.full(3, 30e-3)])


def test_load_uff_ustb_focused_vs(tmp_path):
    """USTB spherical waves with finite-distance sources map to a VS
    sequence with t0 = delay - |focus|/c0 (``src/ChannelData.m:222``)."""
    pytest.importorskip("h5py")
    path = tmp_path / "ustb_vs.uff"
    _write_vs(path, FOCI)
    out = interop.load_uff(path)
    seq, chd = out["seq"], out["chd"]
    assert seq.type == "VS"
    assert np.allclose(seq.focus_array, FOCI, atol=1e-9)
    want_t0 = 1e-6 - np.linalg.norm(FOCI, axis=0) / 1540.0
    assert np.allclose(np.asarray(chd.t0_host).reshape(-1), want_t0)


def test_genuine_uff_fixture_if_available():
    """Environment-gated genuine-USTB validation: point QUPS_UFF_FIXTURE at a
    real USTB/PICMUS .uff file and both packages load it alike. Skips when
    absent, as tests/test_interop.py does."""
    path = os.environ.get("QUPS_UFF_FIXTURE", "")
    if not path or not os.path.exists(path):
        pytest.skip("no genuine UFF fixture available (QUPS_UFF_FIXTURE)")
    out = interop.load_uff(path)
    assert out, "nothing recognized in the genuine UFF file"
    if "chd" in out:
        chd = out["chd"]
        assert chd.T > 0 and chd.N > 0 and chd.M > 0
        assert torch.isfinite(chd.data.abs()).any()
    if "xdc" in out:
        assert out["xdc"].numel > 0
    same_bundle(out, jinterop.load_uff(path))


def _sph_gen(m):
    sph = m.ScanSpherical(r=np.linspace(10e-3, 30e-3, 8), a=np.linspace(-10, 10, 5),
                          e=np.linspace(-4, 4, 3), origin=(0, 1e-3, 2e-3))
    pos = np.random.default_rng(0).uniform(-3e-3, 3e-3, (3, 6, 5, 2))
    return sph, m.ScanGeneric(pos=pos)


def test_uff_spherical_generic_scan_roundtrip(tmp_path):
    """save_uff/load_uff round trip of ScanSpherical (a qups-annotated
    uff.scan) and ScanGeneric (base uff.scan xyz points)."""
    pytest.importorskip("h5py")
    for i, scan in enumerate(_sph_gen(qt)):
        p = tmp_path / f"s{i}.uff"
        interop.save_uff(p, scan=scan)
        s2 = interop.load_uff(p)["scan"]
        assert type(s2) is type(scan)
        P1 = np.asarray(scan.positions()).reshape(3, -1)
        P2 = np.asarray(s2.positions()).reshape(3, -1)
        assert s2.shape == scan.shape
        assert np.abs(P1 - P2).max() < 1e-9


def _write_1x1(path):
    import h5py
    with h5py.File(path, "w") as f:
        g = f.create_group("channel_data")
        g.attrs["class"] = _chararr("UFF.Channel_Data")  # mixed case
        g.create_dataset("data", data=np.zeros((3, 2, 4, 8)))
        g.create_dataset("sampling_frequency", data=np.array([[25e6]]))  # 1x1
        g.create_dataset("initial_time", data=np.array([[1e-6]]))
        g.create_dataset("sound_speed", data=np.array([[1540.0]]))


def test_uff_scalar_as_1x1_datasets(tmp_path):
    """MATLAB writes scalars as 1x1 arrays; every scalar read squeezes, and
    a non-canonical class casing reads with a warning."""
    pytest.importorskip("h5py")
    p = tmp_path / "s.uff"
    _write_1x1(p)
    with pytest.warns(UserWarning, match="casing"):
        out = interop.load_uff(p)
    chd = out["chd"]
    assert float(chd.fs) == 25e6
    assert abs(float(np.asarray(chd.t0_host).reshape(-1)[0]) - 1e-6) < 1e-12


# ------------------------------------------------------------ parity cases
def _trans_variants():
    lin = _trans_struct(16)
    wl = dict(_trans_struct(16), units="wavelengths", elementWidth=0.9, elementLength=16.0)
    wl.pop("spacingMm")
    wl["spacing"] = 1.0
    t = np.arange(64)
    ir = dict(_trans_struct(16), IR1wy=np.sin(2 * np.pi * t / 50) * np.exp(-((t - 30) / 8) ** 2),
              elevationFocusMm=18.0)
    numel = 32
    ang = np.linspace(-0.3, 0.3, numel)
    cpos = np.zeros((numel, 5))
    cpos[:, 0], cpos[:, 2], cpos[:, 3] = 40 * np.sin(ang), 40 * (np.cos(ang) - 1), ang
    convex = dict(_trans_struct(numel, 3.0), type=1, radiusMm=40.0, ElementPos=cpos)
    gx, gy = np.meshgrid((np.arange(8) - 3.5) * 0.3, (np.arange(4) - 1.5) * 0.3)
    mpos = np.zeros((32, 5))
    mpos[:, 0], mpos[:, 1] = gx.ravel(), gy.ravel()
    matrix = dict(_trans_struct(32, 3.0), type=2, ElementPos=mpos)
    gpos = np.random.default_rng(5).uniform(-2, 2, (12, 5))
    generic = dict(_trans_struct(12), type=3, ElementPos=gpos)
    return dict(linear=lin, wavelengths=wl, impulse=ir, convex=convex, matrix=matrix,
                generic=generic)


TRANS = _trans_variants()


@pytest.mark.parametrize("name", list(TRANS))
def test_transducer_parity(name):
    got = interop.transducer_from_verasonics(TRANS[name], 1540.0)
    ref = jinterop.transducer_from_verasonics(TRANS[name], 1540.0)
    same_obj(got, ref)
    np.testing.assert_array_equal(got.positions(), ref.positions())
    if name == "impulse":
        same_waveform(got.impulse, ref.impulse)


def _tx_variants():
    Trans = _trans_struct()
    angs = np.radians([-10.0, 0.0, 10.0])
    pw = _pw_tx(Trans, angs)
    fsa = [dict(Apod=(np.arange(16) == i).astype(float), Steer=np.zeros(2), focus=0.0,
                Origin=np.zeros(3), Delay=np.zeros(16)) for i in range(16)]
    foc = [dict(Apod=np.ones(16), Steer=np.array([a, 0.0]), focus=80.0, Origin=np.zeros(3),
                Delay=np.linspace(0, 1, 16)) for a in angs]
    div = [dict(t, focus=-40.0) for t in foc]
    fp = [dict(Apod=np.ones(16), Steer=np.zeros(2), focus=0.0, Origin=np.zeros(3),
               Delay=np.linspace(0, 1, 16), FocalPt=np.array([x, 0.0, 60.0]))
          for x in (-5.0, 0.0, 5.0)]
    gen = [dict(Apod=np.ones(16), Steer=np.zeros(2), focus=0.0, Origin=np.zeros(3),
                Delay=np.random.default_rng(6).uniform(0, 1, 16))]
    pw_apod = [dict(t, Apod=np.hanning(16)) for t in pw]
    pw_bad = [dict(t, Delay=t["Delay"] + np.linspace(0, 0.5, 16)) for t in pw]
    TW, _ = _tw()
    return {"PW": (pw, None), "FSA": (fsa, None), "FC focus": (foc, None),
            "DV focus": (div, None), "FocalPt": (fp, None), "generic": (gen, None),
            "PW apod override": (pw_apod, None), "PW delay override": (pw_bad, None),
            "PW with TW": (pw, TW)}


TXS = _tx_variants()


@pytest.mark.parametrize("name", list(TXS))
def test_sequence_parity(name):
    """Type inference, the apodization and delay overrides, the per-transmit
    t0 and the TW pulse, each equal to the JAX package's."""
    TX, TW = TXS[name]
    got, t0 = interop.sequence_from_verasonics(TX, _trans_struct(), TW)
    ref, t0r = jinterop.sequence_from_verasonics(TX, _trans_struct(), TW)
    same_obj(got, ref)
    np.testing.assert_array_equal(t0, t0r)
    if TW is not None:
        same_waveform(got.pulse, ref.pulse)


def _hvmux_receive(numel, A, T):
    rx = _receive(numel, A, T, 1)
    for i, r in enumerate(rx):
        r["aperture"] = 1 + i % 2
    return rx


def _chd_variants():
    numel, A, T, F = 16, 4, 32, 3
    rng = np.random.default_rng(7)
    buf = rng.integers(-3000, 3000, (T * A, numel, F)).astype(np.int16)
    perm = _trans_struct(numel)
    perm["ConnectorES"] = rng.permutation(numel) + 1
    perm["ConnectorES"][3] = 0  # an element on no channel reads zeros
    mux = _trans_struct(numel)
    mux["HVMux"] = dict(ApertureES=np.stack([rng.permutation(numel) + 1,
                                             rng.permutation(numel) + 1], 1))
    wide = _trans_struct(numel)
    wide["ConnectorES"] = np.arange(numel) * 17 % 256 + 241  # past NCH = 256: modulo
    out = {"identity": ([buf], _receive(numel, A, T, F), _trans_struct(numel), {}),
           "ConnectorES permutation": ([buf], _receive(numel, A, T, F), perm, {}),
           "ConnectorES past 256": ([np.concatenate([buf] * 16, 1)],
                                    _receive(numel, A, T, F), wide, {}),
           "HVMux apertures": ([buf[..., :1]], _hvmux_receive(numel, A, T), mux, {}),
           "frames 1, 3": ([buf], _receive(numel, A, T, F), perm, dict(frames=[1, 3])),
           "no Trans": ([buf], _receive(numel, A, T, F), None, {})}
    for mode in ("BS100BW", "BS67BW", "BS50BW"):
        out[mode] = ([buf], _receive(numel, A, T, F, fmod=6.25, mode=mode), perm, {})
    out["BS50BW insert0s=False"] = ([buf], _receive(numel, A, T, F, mode="BS50BW"), perm,
                                    dict(insert0s=False))
    return out


CHDS = _chd_variants()


@pytest.mark.parametrize("name", list(CHDS))
def test_channel_data_parity(name):
    """The channel map (ConnectorES, its modulo past 256 channels, HVMux
    apertures), frame selection and the sample modes' zero insertion: the
    port's traces equal the JAX package's bit for bit, float32 on the host."""
    rcv, Receive, Trans, kw = CHDS[name]
    got = interop.channel_data_from_verasonics(rcv, Receive, Trans, **kw)
    ref = jinterop.channel_data_from_verasonics(rcv, Receive, Trans, **kw)
    assert got[1] == ref[1] and got[2] == ref[2]
    for g, r in zip(got[0], ref[0]):
        assert g.data.dtype == torch.float32 and g.data.is_contiguous()
        same_obj(g, r)


def test_channel_map_by_hand():
    """The element traces after the map are the channel columns that
    ConnectorES names, independently of either package."""
    rcv, Receive, Trans, _ = CHDS["ConnectorES permutation"]
    chd = interop.channel_data_from_verasonics(rcv, Receive, Trans)[0][0]
    T, N, A, F = chd.data.shape
    k = np.asarray(Trans["ConnectorES"])
    want = np.zeros((T, N, A, F), np.float32)
    for a in range(A):
        for n in range(N):
            if k[n]:
                want[:, n, a] = rcv[0][a * T:(a + 1) * T, k[n] - 1]
    np.testing.assert_array_equal(chd.data.numpy(), want)


PDATA = {
    "rectangular": dict(Coord="rectangular", Size=np.array([24, 32, 1]),
                        PDelta=np.array([0.5, 0.0, 0.25]), Origin=np.array([-8.0, 0.0, 2.0])),
    "polar": dict(Coord="polar", Size=np.array([20, 16, 1]),
                  PDelta=np.array([0.02, 0.5, 1.0]), Origin=np.array([0.0, 0.0, -3.0])),
    "spherical": dict(Coord="spherical", Size=np.array([10, 8, 6]),
                      PDelta=np.array([0.5, 0.03, 0.04]), Origin=np.array([0.0, 0.0, -2.0])),
}


@pytest.mark.parametrize("name", list(PDATA))
def test_scan_parity(name):
    got = interop.scan_from_verasonics(PDATA[name], 1540 / 5e6)
    ref = jinterop.scan_from_verasonics(PDATA[name], 1540 / 5e6)
    same_obj(got, ref)
    np.testing.assert_array_equal(got.positions(), ref.positions())


@pytest.mark.parametrize("which", ["tri", "1wy", "2wy"])
def test_waveform_parity(which):
    TW, _ = _tw()
    same_waveform(interop.waveform_from_verasonics(TW, which=which),
                  jinterop.waveform_from_verasonics(TW, which=which))


def _vantage_pw(tmp_path, F=2, seed=8):
    """A Vantage plane-wave workspace of a point target: the port's greens
    (device="cpu") of a 24-element L11-4v-like array, 3 plane waves,
    quantized to int16 into RcvData through a permuted ConnectorES, F frames
    (the target 0.3 mm deeper a frame), rows rounded to 128-sample blocks.
    Returns the path, the acquisition's qups-time start and the targets."""
    from scipy.io import savemat
    rng = np.random.default_rng(seed)
    numel, fc, c0, lam = 24, 5.208e6, 1540.0, 1540.0 / 5.208e6
    Trans = dict(_trans_struct(numel, 5.208), ConnectorES=rng.permutation(numel) + 1)
    xdc = interop.transducer_from_verasonics(Trans, c0)
    angs = np.radians([-8.0, 0.0, 8.0])
    seq = qt.SequenceRadial(type="PW", angles=np.degrees(angs), c0=c0)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=qt.ScanCartesian(
        x=np.linspace(-3e-3, 3e-3, 25), z=np.linspace(12e-3, 18e-3, 25)), fs=4 * fc)
    tau = seq.delays(xdc)  # (N, M)
    targets = [np.array([0.5e-3, 0.0, 15e-3 + 0.3e-3 * f]) for f in range(F)]
    silent = np.array([[0.0, 0.0], [0.0, 0.0], [8e-3, 22e-3]])
    chds = [us.greens(qt.Scatterers(pos=np.concatenate([t.reshape(3, 1), silent], 1),
                                    amp=np.array([1.0, 0.0, 0.0]), c0=c0), device="cpu")
            for t in targets]
    x = np.stack([c.data.real.numpy() for c in chds], -1)  # (T, N, M, F), RF
    T = -(-x.shape[0] // 128) * 128
    q16 = np.zeros((T,) + x.shape[1:], np.int16)
    q16[:x.shape[0]] = np.round(x / np.abs(x).max() * 8000).astype(np.int16)
    A = x.shape[2]
    rcv = np.zeros((T * A, numel, F), np.int16)
    k = Trans["ConnectorES"] - 1
    for a in range(A):
        rcv[a * T:(a + 1) * T, k] = q16[:, :, a]
    off = -tau.max(axis=0)  # the qups time of the Vantage delays' zero
    start = chds[0].t0_host[0] - off  # each acquisition's start on the Vantage clock
    Receive = _records([dict(bufnum=1, framenum=f + 1, acqNum=a + 1, startSample=a * T + 1,
                             endSample=(a + 1) * T, decimSampleRate=4 * 5.208,
                             demodFrequency=5.208, sampleMode="NS200BW",
                             startDepth=start[a] * fc / 2, Apod=np.ones(numel))
                        for f in range(F) for a in range(A)])
    TX = _records([dict(Apod=np.ones(numel), Steer=np.array([a, 0.0]), focus=0.0,
                        Origin=np.zeros(3), Delay=(tau[:, m].max() - tau[:, m]) * fc)
                   for m, a in enumerate(angs)])
    PData = dict(Coord="rectangular", Size=np.array([25, 25, 1]),
                 PDelta=np.array([0.25e-3 / lam, 0.0, 0.25e-3 / lam]),
                 Origin=np.array([-3.125e-3 / lam, 0.0, 12e-3 / lam]))
    ws = dict(Trans=Trans, Receive=Receive, TX=TX, PData=PData,
              RcvData=np.empty((1,), object), Resource=dict(Parameters=dict(speedOfSound=c0)))
    ws["RcvData"][0] = rcv
    p = tmp_path / "vantage_pw.mat"
    savemat(p, ws, long_field_names=True)
    return p, start, off, q16, targets


def test_load_verasonics_parity_and_das(tmp_path):
    """A Vantage plane-wave workspace of a point target, 2 frames: both
    packages' load_verasonics give equal objects, per-transmit t0 and
    traces; the traces are the int16 samples written, after the channel
    map; with the acquisition's start added to out['t0'], the port's DAS
    (device="cpu") is within 1e-4 of the JAX package's and each frame's
    peak lies on its target."""
    p, start, off, q16, targets = _vantage_pw(tmp_path)
    got, ref = interop.load_verasonics(p), jinterop.load_verasonics(p)
    same_bundle(got, ref)
    np.testing.assert_allclose(got["t0"], off, rtol=0, atol=1e-15)
    chd = got["chd"][0]
    np.testing.assert_array_equal(chd.data.numpy(), q16.astype(np.float32))
    assert got["fmod"] == [5.208e6] and got["smode"] == ["NS200BW"]
    t0 = (start + got["t0"]).reshape(1, 1, -1)
    b = das_parity(got["xdc"], got["seq"], got["scan"], chd,
                   ref["xdc"], ref["seq"], ref["scan"], ref["chd"][0], t0=t0)
    for f, tg in enumerate(targets):
        _psf(b[..., f], got["scan"], tg)


UFFS = {"own dialect": lambda p: interop.save_uff(p, **_uff_bundle(qt)),
        "ustb": lambda p: _write_ustb(p, np.random.default_rng(3).standard_normal(
            (32, 8, 3)).astype(np.float32), np.radians([-10.0, 0.0, 10.0])),
        "picmus iq": _picmus_like,
        "focused vs": lambda p: _write_vs(p, FOCI),
        "1x1 scalars": _write_1x1}


@pytest.mark.parametrize("name", list(UFFS))
def test_uff_parity(tmp_path, name):
    """Each UFF fixture: both packages' load_uff give the same bundle."""
    pytest.importorskip("h5py")
    p = tmp_path / "f.uff"
    UFFS[name](p)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the 1x1 fixture's casing warning, both packages
        got, ref = interop.load_uff(p), jinterop.load_uff(p)
    same_bundle(got, ref)


def test_uff_picmus_das_parity(tmp_path):
    """The PICMUS-like IQ bundle's DAS with fmod: port (device="cpu") within
    1e-4 of the JAX package."""
    pytest.importorskip("h5py")
    p = tmp_path / "picmus.uff"
    _, target = _picmus_like(p)
    got, ref = interop.load_uff(p), jinterop.load_uff(p)
    b = das_parity(got["xdc"], got["seq"], got["scan"], got["chd"],
                   ref["xdc"], ref["seq"], ref["scan"], ref["chd"], fmod=got["fmod"])
    _psf(b, got["scan"], target)


def _scans(m):
    return {"cartesian": m.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 9), z=np.linspace(0, 2e-2, 7)),
            "polar": m.ScanPolar(origin=(0, 0, -1e-3), r=np.linspace(0, 3e-2, 6),
                                 a=np.linspace(-30, 30, 5)),
            "spherical": _sph_gen(m)[0], "generic": _sph_gen(m)[1]}


def _xdcs(m):
    return {"array": m.TransducerArray(numel=8, pitch=0.4e-3, fc=6e6),
            "convex": m.TransducerConvex(numel=12, radius=40e-3, fc=3e6),
            "matrix": m.TransducerMatrix(pitch2=(0.3e-3, 0.3e-3), numd=(4, 3), fc=3e6),
            "generic": m.TransducerGeneric(
                pos=np.random.default_rng(1).uniform(-5e-3, 5e-3, (3, 7)),
                az=np.linspace(-10, 10, 7), el=np.linspace(0, 5, 7))}


def _cross_bundle(m, scan, xdc, seq):
    b = dict(_uff_bundle(m), scan=_scans(m)[scan], xdc=_xdcs(m)[xdc])
    if seq == "FSA":
        b["seq"] = m.Sequence(type="FSA", numpulse=2, c0=1500.0)
    return b


@pytest.mark.parametrize("scan,xdc,seq", [("cartesian", "array", "PW"),
                                          ("polar", "convex", "FSA"),
                                          ("spherical", "matrix", "FSA"),
                                          ("generic", "generic", "PW")])
def test_uff_files_cross_packages(tmp_path, scan, xdc, seq):
    """A .uff written by either package loads in the other to the same
    bundle (each scan type, each transducer type, a FSA and a PW sequence,
    complex traces with a per-transmit t0)."""
    pytest.importorskip("h5py")
    pj, pt = tmp_path / "jax.uff", tmp_path / "port.uff"
    jinterop.save_uff(pj, **_cross_bundle(q, scan, xdc, seq))
    interop.save_uff(pt, **_cross_bundle(qt, scan, xdc, seq))
    for p in (pj, pt):
        same_bundle(interop.load_uff(p), jinterop.load_uff(p))


def test_save_uff_takes_a_system(tmp_path):
    """``us=``: the system's rx transducer, sequence and scan fill what is
    not given, as in the JAX package."""
    pytest.importorskip("h5py")
    b = _uff_bundle(qt)
    us = qt.UltrasoundSystem(tx=b["xdc"], rx=b["xdc"], seq=b["seq"], scan=b["scan"], fs=20e6)
    p = tmp_path / "us.uff"
    interop.save_uff(p, chd=b["chd"], us=us)
    out = interop.load_uff(p)
    same_bundle(out, jinterop.load_uff(p))
    assert out.keys() == {"chd", "xdc", "seq", "scan"}
    np.testing.assert_array_equal(out["xdc"].positions(), b["xdc"].positions())


def _mat_objs(m):
    return dict(xdc=m.TransducerConvex(numel=12, radius=40e-3, fc=3e6),
                seq=m.SequenceRadial(type="PW", angles=np.linspace(-16, 16, 7), c0=1540.0),
                scan=m.ScanCartesian(x=np.linspace(-18e-3, 18e-3, 16),
                                     z=np.linspace(10e-3, 50e-3, 12)),
                pol=m.ScanPolar(origin=(0, 0, -1e-3), r=np.linspace(0, 30e-3, 8),
                                a=np.linspace(-30, 30, 5)),
                arr=m.TransducerArray.L11_5v(), fsa=m.Sequence(type="FSA", numpulse=4))


def test_mat_files_cross_packages(tmp_path):
    """A .mat written by either package's save_mat loads in the other's
    load_mat to the same objects."""
    pj, pt = tmp_path / "jax.mat", tmp_path / "port.mat"
    jinterop.save_mat(pj, **_mat_objs(q))
    interop.save_mat(pt, **_mat_objs(qt))
    for p in (pj, pt):
        got, ref = interop.load_mat(p), jinterop.load_mat(p)
        assert got.keys() == ref.keys() == _mat_objs(q).keys()
        for k in got:
            same_obj(got[k], ref[k])
    # and the port's file holds the port's objects' fields
    back = interop.load_mat(pt)
    for k, v in _mat_objs(qt).items():
        _same(_data(_dict(back[k])), _data(_dict(v)), k)
