"""The port's LUT delay-and-sum (qups_tpu_torch.ops.das.das_lut, the plain
version of kernel K2) against qups_tpu's das_lut in every mode and against
the Pallas LUT kernel das_lut_tiled in interpret mode, frames and IQ
remodulation (sub-slice K2(b)) among them; the wrapper's CPU path; and the
system's
das_delay_tables, bfDAS, bfDASLUT and per-pixel sound-speed DAS against the
JAX system. K2 itself is tested on the card in test_torch_cuda.py.
Tolerance: max|port - JAX| < 1e-4 * max|JAX|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
from qups_tpu.ops.das import das_lut as das_lut_ref  # noqa: E402
from qups_tpu.ops.das_pallas import das_lut_tiled  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import das_cuda  # noqa: E402
from qups_tpu_torch.ops.das import das_lut  # noqa: E402
from qups_tpu_torch.ops.interp import METHODS  # noqa: E402
from test_torch_das import (IQ_CASES, assert_flips_only, frame_traces,  # noqa: E402
                            steady)  # (the nearest attribution)

FS = 4e6
TARGET = np.array([0.0, 0.0, 20e-3])


def lut_problem(T=256, N=16, M=4, I1=16, I2=32, seed=50, cplx=False):
    """Plane-wave geometric tables plus a seeded perturbation of up to +-2
    samples (so the tables are not separable geometry); t0 puts some delays
    below 0 and some above T-1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal((T, N, M))).astype(np.complex64)
    Z, X = np.meshgrid(np.linspace(5e-3, 45e-3, I1), np.linspace(-12e-3, 12e-3, I2),
                       indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1)
    pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N), np.zeros(N)], -1)
    th = np.radians(np.linspace(-9, 9, M))
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1)
    I = pi.shape[0]
    tau_rx = (np.linalg.norm(pi[:, None] - pr[None], axis=-1) / 1540.0
              + rng.uniform(-2, 2, (I, N)) / FS).astype(np.float32)
    tau_tx = (pi @ nv.T / 1540.0 + rng.uniform(-2, 2, (I, M)) / FS).astype(np.float32)
    t0 = (2 * 12e-3 / 1540.0 + np.linspace(0, 2e-6, M)).astype(np.float32)
    return x, tau_rx, tau_tx, t0


def lut_delays64(tau_rx, tau_tx, t0):
    """Every term's fractional sample index ti (I, M, N) in float64 from the
    same float32 tables, ((tau_tx + tau_rx) - t0) fs with fs rounded to
    float32, and the largest value on the way, (|tau_tx| + |tau_rx| + |t0|)
    fs, per term."""
    tr = np.asarray(tau_rx, np.float64)[:, None, :]
    tt = np.asarray(tau_tx, np.float64)[:, :, None]
    t = np.asarray(t0, np.float64)[None, :, None]
    f = np.float64(np.float32(FS))
    return ((tt + tr) - t) * f, (np.abs(tt) + np.abs(tr) + np.abs(t)) * f


def check(got, ref, flips=None):
    """Every pixel within 1e-4 max|ref|; with ``flips`` (the nearest
    sampler's exact delays and their scale, from lut_delays64, and T), a pixel
    may differ only where test_torch_das.assert_flips_only attributes it to
    a delay on the edge of a rounding or of the valid range."""
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    off = np.abs(got - ref) >= 1e-4 * np.abs(ref).max()
    if flips is None:
        assert not off.any()
    else:
        # XLA on the CPU may contract the reference's delay sum into FMAs,
        # depending on the CPU it compiles for (as in test_torch_das.py)
        assert_flips_only(off.reshape(-1), *flips)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_das_lut_summed_matches_reference(method, cplx):
    x, tau_rx, tau_tx, t0 = lut_problem(cplx=cplx)
    kw = dict(fs=FS, method=method)
    check(torch.as_tensor(steady("the port", lambda: das_lut(
              torch.as_tensor(x), tau_rx, tau_tx, t0, **kw).numpy())),
          steady("the JAX reference",
                 lambda: np.asarray(das_lut_ref(x, tau_rx, tau_tx, t0, **kw))),
          (*lut_delays64(tau_rx, tau_tx, t0), x.shape[0]) if method == "nearest" else None)


@pytest.mark.parametrize("case", ["keep_rx", "keep_tx", "fmod", "apod"])
def test_das_lut_modes_match_reference(case):
    x, tau_rx, tau_tx, t0 = lut_problem(cplx=case == "fmod")
    kw = dict(fs=FS, method="linear")
    if case == "apod":
        rng = np.random.default_rng(51)
        kw.update(im_shape=(16, 32, 1),
                  apod=(rng.uniform(size=(16, 32, 1, 16, 4)).astype(np.float32),))
    elif case == "fmod":
        kw["fmod"] = 1e6
    else:
        kw[case] = True
    check(das_lut(torch.as_tensor(x), tau_rx, tau_tx, t0, **kw),
          das_lut_ref(x, tau_rx, tau_tx, t0, **kw))


def test_das_lut_matches_pallas_interpret():
    """The plain version against the TPU kernel itself (LUT mode), run as
    the JAX package's own tests run it on the CPU."""
    x, tau_rx, tau_tx, t0 = lut_problem(I1=8, I2=128)
    ref = np.asarray(das_lut_tiled(x, tau_rx, tau_tx, t0, fs=FS, im_shape=(8, 128, 1),
                                   method="cubic", precision="f32",
                                   interpret=True)).reshape(-1)
    got = das_lut(torch.as_tensor(x), tau_rx, tau_tx, t0, fs=FS,
                  method="cubic").numpy().reshape(-1)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("case", sorted(IQ_CASES))
def test_das_lut_frames_fmod_match_pallas_interpret(case):
    """Frames and IQ remodulation (sub-slice K2(b)) in the plain das_lut,
    the version K2 is held to on the card, against the TPU kernel in LUT
    mode, interpret mode; and the K2 wrapper on a CPU tensor is that plain
    version, with no launch."""
    fdims, cplx, fmod = IQ_CASES[case]
    x, tau_rx, tau_tx, t0 = lut_problem(I1=8, I2=128)
    xf = frame_traces(x, fdims, cplx, seed=52)
    kw = dict(fs=FS, method="cubic", fmod=fmod)
    ref = np.asarray(das_lut_tiled(xf, tau_rx, tau_tx, t0, im_shape=(8, 128, 1),
                                   precision="f32", interpret=True, **kw))
    got = das_lut(torch.as_tensor(xf), tau_rx, tau_tx, t0, **kw)
    assert tuple(got.shape) == (tau_rx.shape[0], 1, 1) + fdims
    check(got, ref.reshape(got.shape))
    before = das_cuda.LUT_LAUNCHES, das_cuda.LAYOUT_LAUNCHES
    assert torch.equal(das_cuda.das_lut_sum(torch.as_tensor(xf), tau_rx, tau_tx,
                                            t0[None, None], **kw), got)
    assert (das_cuda.LUT_LAUNCHES, das_cuda.LAYOUT_LAUNCHES) == before


def test_das_lut_sum_cpu_is_plain():
    """On a CPU tensor the K2 wrapper runs the plain version and launches
    nothing."""
    x, tau_rx, tau_tx, t0 = lut_problem()
    before = das_cuda.LUT_LAUNCHES
    args = (torch.as_tensor(x), tau_rx, tau_tx, t0)
    got = das_cuda.das_lut_sum(*args, fs=FS, method="cubic")
    assert torch.equal(got, das_lut(*args, fs=FS, method="cubic"))
    assert das_cuda.LUT_LAUNCHES == before


@pytest.fixture(scope="module")
def pw():
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=q.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]), c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 32),
                             z=np.linspace(16e-3, 24e-3, 32)))
    chd = us.greens(q.Scatterers(pos=TARGET[:, None], c0=1540.0))
    return us, chd, from_reference(us), from_reference(chd)


def test_das_delay_tables_match_reference(pw):
    us, _, ust, _ = pw
    for got, ref in zip(ust.das_delay_tables(device="cpu"), us.das_delay_tables()):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("call", ["bfDAS", "bfDAS_keep_rx", "bfDASLUT", "DAS_c0_map"])
def test_lut_beamformers_match_reference(pw, call):
    us, chd, ust, chdt = pw
    if call == "bfDAS":
        ref, got = us.bfDAS(chd), ust.bfDAS(chdt, device="cpu")
    elif call == "bfDAS_keep_rx":
        ref, got = us.bfDAS(chd, keep_rx=True), ust.bfDAS(chdt, keep_rx=True, device="cpu")
    elif call == "bfDASLUT":
        tau_rx, tau_tx = (np.asarray(a) for a in us.das_delay_tables(c0=1500.0))
        ref = us.bfDASLUT(chd, tau_rx, tau_tx, method="lanczos3")
        got = ust.bfDASLUT(chdt, tau_rx, tau_tx, method="lanczos3", device="cpu")
    else:
        cmap = np.linspace(1500.0, 1580.0, 32 * 32).reshape(us.scan.shape)
        ref, got = us.DAS(chd, c0=cmap), ust.DAS(chdt, c0=cmap, device="cpu")
    check(got, ref)


def test_constant_c_map_is_scalar_c(pw):
    """A constant per-pixel sound-speed map gives the scalar-c image."""
    _, _, ust, chdt = pw
    b = ust.DAS(chdt, device="cpu")
    bc = ust.DAS(chdt, c0=np.full(ust.scan.shape, 1540.0), device="cpu")
    assert float((bc - b).abs().max()) < 1e-4 * float(b.abs().max())
    bl = ust.bfDAS(chdt, device="cpu")
    assert float((bl - b).abs().max()) < 1e-4 * float(b.abs().max())


def test_lut_scope_on_cpu(pw):
    """kernel='cuda' needs CUDA traces; 'cubic2x' (the linear sampler on
    traces upsampled 2x) runs on the CPU as in the JAX package."""
    us, chd, ust, chdt = pw
    with pytest.raises(ValueError, match="CUDA"):
        ust.bfDAS(chdt, kernel="cuda", device="cpu")
    check(ust.bfDAS(chdt, method="cubic2x", device="cpu"), us.bfDAS(chd, method="cubic2x"))
