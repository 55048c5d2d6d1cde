"""The port's simulator family against qups_tpu's: simus_fsa (the plain
version of kernel K3 with its sinc directivity, K3(c)) against both JAX
engines, the fused one in interpret mode; and UltrasoundSystem.simus,
calc_scat_all, calc_scat_multi (blocked and fused) and calc_hp in both
packages, at the sizes of tests/test_sim.py.

simus: rel-norm < 2e-4, the JAX test's own bound between its two engines
(tests/test_sim.py:318); with bf16 operands 5e-3 (tests/test_greens_freq.py
:186). The system calls: max|port - JAX| < 1e-4 max|JAX| unless a test
says otherwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu.ops.simus import _bin_runs as bin_runs_ref  # noqa: E402
from qups_tpu.ops.simus import simus_fsa as simus_fsa_ref  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import greens_freq_cuda  # noqa: E402
from qups_tpu_torch.ops.simus import _bin_runs, simus_fsa  # noqa: E402

TOL = 1e-4


def problem(seed=11, S=9, N=5, E=3, T=256, F=28):
    """tests/test_sim.py:295-325's sizes, from a seed."""
    rng = np.random.default_rng(seed)
    ps = np.stack([rng.uniform(-2e-3, 2e-3, S), np.zeros(S),
                   rng.uniform(8e-3, 12e-3, S)], -1).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, S).astype(np.float32)
    pn = np.stack([np.linspace(-2e-3, 2e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    pv = pn[:E].copy()
    az = np.linspace(-0.1, 0.1, N).astype(np.float32)
    bins = np.arange(12, 12 + F, dtype=np.int32)
    spec = (rng.standard_normal(F) + 1j * rng.standard_normal(F)).astype(np.complex64)
    args = (ps, amp, pn, az, pv, az[:E], np.array([0.25e-3, 0.25e-3]), spec, bins)
    return args, dict(T=T, fs=10e6, c0=1540.0)


def _relnorm(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_bin_runs_match_reference():
    assert _bin_runs(np.array([3, 4, 5]), merge_gap=4) == [(3, 6)]
    assert _bin_runs(np.array([3, 4, 200, 202]), merge_gap=4) == [(3, 5), (200, 203)]
    b = np.sort(np.random.default_rng(30).choice(500, 60, replace=False))
    assert _bin_runs(b) == bin_runs_ref(b)


@pytest.mark.parametrize("baffle", ["soft", "hard"])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_simus_fsa_matches_reference(engine, baffle):
    args, kw = problem()
    ref = np.asarray(simus_fsa_ref(*args, engine=engine, baffle=baffle, **kw))
    before = greens_freq_cuda.LAUNCHES
    got = simus_fsa(*args, baffle=baffle, device="cpu", **kw)
    assert greens_freq_cuda.LAUNCHES == before  # the plain version, on the CPU
    assert got.dtype == torch.float32
    assert _relnorm(got.numpy(), ref) < 2e-4


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_simus_fsa_attenuation_matches_reference(engine):
    args, kw = problem(seed=7, S=5, N=4, F=30)
    ref = np.asarray(simus_fsa_ref(*args, engine=engine, alpha0=1.0, **kw))
    got = simus_fsa(*args, alpha0=1.0, device="cpu", **kw).numpy()
    assert _relnorm(got, ref) < 2e-4
    lossless = simus_fsa(*args, device="cpu", **kw).numpy()
    assert np.abs(got).max() < np.abs(lossless).max()


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_simus_fsa_bf16_matches_reference(engine):
    """K3(b) with K3(c): the operands rounded to bfloat16 after the
    directivity weight, in both packages."""
    args, kw = problem(seed=12)
    ref = np.asarray(simus_fsa_ref(*args, engine=engine, precision="bf16", **kw))
    got = simus_fsa(*args, precision="bf16", device="cpu", **kw).numpy()
    assert _relnorm(got, ref) < 5e-3
    f32 = simus_fsa(*args, device="cpu", **kw).numpy()
    assert 0 < _relnorm(got, f32) < 5e-3  # the rounding is there, and small


def test_simus_fsa_sparse_bins_and_options():
    """Two lobes of bins split into two runs, as in the JAX package; no bins
    give zeros; unknown options raise."""
    args, kw = problem(seed=13, S=5, N=4)
    bins = np.array([10, 11, 12, 90, 91], np.int32)
    spec = (np.arange(5) + 1j).astype(np.complex64)
    a = args[:7] + (spec, bins)
    ref = np.asarray(simus_fsa_ref(*a, engine="xla", **kw))
    assert _relnorm(simus_fsa(*a, device="cpu", **kw).numpy(), ref) < 2e-4
    zero = simus_fsa(*args[:7], spec[:0], bins[:0], device="cpu", **kw)
    assert zero.shape == (kw["T"], 4, 3) and not bool(zero.any())
    with pytest.raises(ValueError, match="baffle"):
        simus_fsa(*args, baffle="rigid", device="cpu", **kw)
    with pytest.raises(ValueError, match="precision"):
        simus_fsa(*args, precision="f16", device="cpu", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        simus_fsa(*args, kernel="cuda", device="cpu", **kw)


def _systems(seq=None, numel=8, fs=20e6):
    xdc = q.TransducerArray(numel=numel, pitch=0.3e-3, fc=4e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=seq or q.Sequence(type="FSA", numpulse=numel, c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 16),
                             z=np.linspace(10e-3, 14e-3, 16)), fs=fs)
    rng = np.random.default_rng(31)
    pos = np.stack([rng.uniform(-2e-3, 2e-3, 5), np.zeros(5), rng.uniform(11e-3, 13e-3, 5)])
    scat = q.Scatterers(pos=pos, amp=rng.uniform(0.5, 1.5, 5), c0=1540.0)
    return us, from_reference(us), scat, from_reference(scat)


@pytest.mark.parametrize("baffle", ["soft", "hard"])
def test_system_simus_matches_reference(baffle):
    """UltrasoundSystem.simus in both packages (the JAX package's XLA engine
    on the CPU), then the identity focusTx of FSA."""
    us, ust, scat, scatt = _systems()
    ref = us.simus(scat, baffle=baffle)
    got = ust.simus(scatt, baffle=baffle, device="cpu")
    assert got.t0 == ref.t0 and got.data.dtype == torch.float32
    assert _relnorm(got.data.numpy(), np.asarray(ref.data)) < 2e-4


def test_system_simus_plane_waves_and_bf16():
    """simus with a plane-wave sequence (the cubic focusTx on the CPU), and
    on the same system greens(impl='freq', precision='bf16') (K3(b)'s plain
    version, then focusTx), each against the JAX package's call."""
    pw = q.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]), c0=1540.0)
    us, ust, scat, scatt = _systems(pw)
    ref = us.simus(scat)
    got = ust.simus(scatt, device="cpu")
    assert got.data.shape == tuple(ref.data.shape)
    assert _relnorm(got.data.numpy(), np.asarray(ref.data)) < 2e-4
    kw = dict(impl="freq", precision="bf16")
    ref = np.asarray(us.greens(scat, **kw).data)
    got = ust.greens(scatt, device="cpu", **kw).data.numpy()
    assert got.shape == ref.shape and _relnorm(got, ref) < 5e-3


def test_simus_tof_oracle():
    """The echo of the centre element peaks at the round-trip time, within
    1.5 wavelengths (the JAX test's SIMUS oracle)."""
    C0, z_t = 1540.0, 15.4e-3
    xdc = qt.TransducerArray(numel=16, pitch=0.3e-3, fc=5e6)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=16, c0=C0),
                             scan=qt.ScanCartesian(), fs=25e6)
    chd = us.simus(qt.Scatterers(pos=np.array([[0.0], [0.0], [z_t]]), c0=C0), device="cpu")
    x = chd.data[:, 8, 8].numpy()
    t = chd.time.reshape(-1).numpy()
    assert abs(t[np.argmax(np.abs(x))] - 2 * z_t / C0) < 1.5 / xdc.fc


@pytest.mark.parametrize("impl", ["splat", "freq", "precision bf16"])
def test_calc_scat_all_is_greens(impl):
    """calc_scat_all is greens with its keyword arguments, in the port, and
    agrees with the JAX package's."""
    us, ust, scat, scatt = _systems()
    kw = dict(impl="freq", precision="bf16") if impl == "precision bf16" else dict(impl=impl)
    a = ust.calc_scat_all(scatt, device="cpu", **kw)
    b = ust.greens(scatt, device="cpu", **kw)
    assert torch.equal(a.data, b.data) and a.t0 == b.t0
    ref = np.asarray(us.calc_scat_all(scat, **kw).data)
    tol = 5e-3 if impl == "precision bf16" else 2e-4
    assert _relnorm(a.data.numpy(), ref) < tol


def _pw():
    th = np.radians([-5.0, 0.0, 5.0, 10.0])
    return q.Sequence(type="PW", focus=np.stack([np.sin(th), 0 * th, np.cos(th)]),
                      c0=1540.0)


@pytest.mark.parametrize("bsize", [None, 1, 3])
def test_calc_scat_multi_matches_reference(bsize):
    """calc_scat_multi with the plane waves of tests/test_sim.py:338-356:
    the port's blocked and fused results agree with each other (t0 bit for
    bit, traces to 1e-6 of the peak) and with the JAX package's."""
    us, ust, scat, scatt = _systems(_pw())
    full = ust.calc_scat_multi(scatt, impl="splat", device="cpu")
    got = ust.calc_scat_multi(scatt, impl="splat", bsize=bsize, device="cpu")
    assert got.data.shape == full.data.shape == (full.T, 8, 4)
    np.testing.assert_array_equal(np.asarray(got.t0, np.float64), np.asarray(full.t0, np.float64))
    assert float((got.data - full.data).abs().max()) < 1e-6 * float(full.data.abs().max())
    ref = us.calc_scat_multi(scat, impl="splat", bsize=bsize)
    np.testing.assert_array_equal(np.asarray(got.t0, np.float32).reshape(-1),
                                  np.asarray(ref.t0, np.float32).reshape(-1))
    assert _rel(got.data.numpy(), np.asarray(ref.data)) < 2e-4


def test_calc_scat_multi_freq_blocks_and_fsa():
    """The 'freq' synthesis in blocks equals it fused; an FSA sequence is
    greens itself."""
    us, ust, scat, scatt = _systems(_pw())
    full = ust.calc_scat_multi(scatt, impl="freq", method="freq", device="cpu")
    blk = ust.calc_scat_multi(scatt, impl="freq", method="freq", bsize=2,
                                device="cpu")
    assert float((blk.data - full.data).abs().max()) < 1e-5 * float(full.data.abs().max())
    ref = us.calc_scat_multi(scat, impl="freq", method="freq", bsize=2)
    assert _rel(blk.data.numpy(), np.asarray(ref.data)) < 2e-4
    _, ust_fsa, _, _ = _systems()
    a = ust_fsa.calc_scat_multi(scatt, impl="splat", device="cpu")
    assert torch.equal(a.data, ust_fsa.greens(scatt, impl="splat", device="cpu").data)


@pytest.mark.parametrize("seq", ["FC", "PW", "DV"])
def test_calc_hp_matches_reference(seq):
    """calc_hp's max-pressure map (tests/test_sim.py:134-170's systems; PW
    and DV cut to 16 elements) in both packages, and the focal oracle for
    FC."""
    C0 = 1540.0
    xdc = q.TransducerArray(numel=32 if seq == "FC" else 16, pitch=0.3e-3, fc=5e6)
    if seq == "FC":
        s = q.Sequence(type="FC", focus=np.array([[0.0], [0.0], [15e-3]]), c0=C0)
    elif seq == "PW":
        s = q.Sequence(type="PW", focus=np.array([[0.0], [0.0], [1.0]]), c0=C0)
    else:
        s = q.Sequence(type="DV", focus=np.array([[0.0, 2e-3], [0.0, 0.0], [-5e-3, -5e-3]]),
                       c0=C0)
    scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 33), y=[0.0],
                           z=np.linspace(5e-3, 25e-3, 41))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=s, scan=scan, fs=40e6)
    ust = from_reference(us)
    ref = np.asarray(us.calc_hp())
    got = ust.calc_hp(device="cpu")
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == ref.shape
    assert _rel(got.numpy(), ref) < TOL
    if seq == "FC":
        pm = got[..., 0].squeeze().numpy()
        iz, ix = np.unravel_index(np.argmax(pm), pm.shape)
        assert np.hypot(scan.x[ix], scan.z[iz] - 15e-3) < 1.1e-3


def test_calc_hp_field():
    """calc_hp(out='field'): the time series and its start time agree with
    the JAX package's."""
    xdc = q.TransducerArray(numel=8, pitch=0.3e-3, fc=5e6)
    s = q.Sequence(type="FC", focus=np.array([[0.0, 1e-3], [0.0, 0.0], [12e-3, 12e-3]]),
                   c0=1540.0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=s, fs=30e6,
                            scan=q.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 9),
                                                 z=np.linspace(10e-3, 14e-3, 9)))
    ref, t0r = us.calc_hp(out="field")
    got, t0 = from_reference(us).calc_hp(out="field", device="cpu")
    assert t0 == t0r and got.shape == ref.shape
    assert _rel(got.numpy(), np.asarray(ref)) < TOL
    with pytest.raises(ValueError, match="out"):
        from_reference(us).calc_hp(out="mean", device="cpu")


def test_cheat_sheet_simulation_block():
    """examples/cheat_sheet.py's simulation block (greens, greens with
    precision='bf16', simus, calc_hp with its FC sequence) in the port,
    against the same calls in the JAX package."""
    c0 = 1540.0
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=5e6)
    ang = np.radians([-10.0, 0.0, 10.0])
    seq_pw = q.Sequence(type="PW", focus=np.stack([np.sin(ang), 0 * ang, np.cos(ang)]), c0=c0)
    seq_fc = q.Sequence(type="FC", focus=np.array(
        [[-2e-3, 0.0, 2e-3], [0, 0, 0], [20e-3, 20e-3, 20e-3]]), c0=c0)
    scan = q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 64), y=[0.0],
                           z=np.linspace(12e-3, 24e-3, 64))
    scat = q.Scatterers(pos=np.array([[0.0], [0.0], [18e-3]]), c0=c0)
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq_pw, scan=scan, fs=25e6)
    ust, scatt = from_reference(us), from_reference(scat)
    for name, ref, got, tol in (
            ("greens", us.greens(scat).data, ust.greens(scatt, device="cpu").data, 2e-4),
            ("greens bf16", us.greens(scat, precision="bf16").data,
             ust.greens(scatt, precision="bf16", device="cpu").data, 2e-4),
            ("simus", us.simus(scat).data, ust.simus(scatt, device="cpu").data, 2e-4),
            ("calc_hp", us.replace(seq=seq_fc).calc_hp(),
             ust.replace(seq=from_reference(seq_fc)).calc_hp(device="cpu"), TOL)):
        assert _rel(got.numpy(), np.asarray(ref)) < tol, name
