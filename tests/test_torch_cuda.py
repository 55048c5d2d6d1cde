"""Kernels K1-K5 on a CUDA card: K1 against its plain PyTorch version for
every transmit model and sampler, real and complex; K2 against das_lut for
every sampler, real and complex; K3 against its plain version, with its
bf16 operands on the tensor cores (K3(b)) and its sinc directivity (K3(c));
K4 against bf_adjoint for every keep mode and precision, at the main
arrays' shapes and with the phasors built per chunk; two launches of K3(b)
and K4 bit-identical; K5 against splat_plain for
both bases, sub-elements and a complex kernel; the sim→image path
greens → DAS, the plane-wave path greens → focusTx → DAS / bfDAS /
per-pixel-c DAS / bfAdjoint and the simulator family (greens pallas and
bf16, simus, calc_scat_multi, calc_hp) on CUDA tensors; and
NotImplementedError for every option a kernel does not carry yet. Every
test here needs the card and skips without one.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch.ops import das_cuda, fdbf_cuda, greens_cuda, greens_freq_cuda  # noqa: E402
from qups_tpu_torch.ops.fdbf import bf_adjoint  # noqa: E402
from qups_tpu_torch.ops.greens_freq import prologue  # noqa: E402
from qups_tpu_torch.ops.interp import METHODS  # noqa: E402

CINV = np.float32(1 / 1540.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("K1-K5 are CUDA C++; they run only on a CUDA device")
    return torch.device("cuda")


def problem(model, T=512, N=32, M=8, n=64):
    rng = np.random.default_rng(40)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    Z, X = np.meshgrid(np.linspace(5e-3, 45e-3, n), np.linspace(-12e-3, 12e-3, n),
                       indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)
    pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    if model == "plane":
        th = np.radians(np.linspace(-9, 9, M))
        pv = np.zeros((M, 3), np.float32)
        nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1).astype(np.float32)
    else:
        zf = -10e-3 if model == "diverging" else 20e-3
        pv = np.stack([np.linspace(-3e-3, 3e-3, M), np.zeros(M), np.full(M, zf)],
                      -1).astype(np.float32)
        nv = np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
    t0 = (2 * 12e-3 / 1540.0 + np.linspace(0, 2e-6, M)).astype(np.float32)
    return x, pi, pr, pv, nv, t0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["plane", "diverging", "virtual"])
def test_k1_matches_plain(card, model):
    x, pi, pr, pv, nv, t0 = problem(model)
    xc = x * np.exp(1j * np.linspace(0, 6, x.shape[0]))[:, None, None]
    for xg, method in [(torch.as_tensor(a, device=card), m)
                       for a in (x, xc.astype(np.complex64)) for m in METHODS]:
        kw = dict(fs=4e6, tx_model=model, method=method)
        before = das_cuda.LAUNCHES
        got = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, **kw)
        torch.cuda.synchronize()
        assert das_cuda.LAUNCHES == before + 1
        ref = das_cuda.das_sum_plain(xg, pi, pr, pv, nv, t0, CINV, **kw)
        assert got.dtype == ref.dtype == xg.dtype
        assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("S,E", [(5, 1), (300, 1), (37, 2)])
def test_k3_matches_plain(card, S, E):
    """K3 against its plain version on the same prologue output: a few
    targets, a cloud (several scatterer chunks), sub-elements; 130 x 70
    elements leave partial output tiles."""
    rng = np.random.default_rng(41)
    ps = np.stack([rng.uniform(-5e-3, 5e-3, S), np.zeros(S),
                   rng.uniform(10e-3, 30e-3, S)], -1)
    amp = rng.uniform(0.5, 1.5, S)
    pn = np.stack([np.linspace(-10e-3, 10e-3, 130), np.zeros(130), np.zeros(130)], -1)
    pv = np.stack([np.linspace(-5e-3, 5e-3, 70), np.zeros(70), np.zeros(70)], -1)
    pn = pn[:, None] + np.arange(E)[None, :, None] * np.array([5e-5, 0, 0])
    pv = pv[:, None] + np.arange(E)[None, :, None] * np.array([5e-5, 0, 0])
    phc = np.float32(2 * np.pi / 1540.0 * 20e6 / 4096)
    q1, w1, q2, w2 = prologue(phc, ps, amp, pn, pv, R0=2e-4, fsr=1.0, device=card)
    for att in (0.0, 1e-3):
        before = greens_freq_cuda.LAUNCHES
        got = greens_freq_cuda.freq_gemm(q1, w1, q2, w2, k0=40, F=300, att=att)
        torch.cuda.synchronize()
        assert greens_freq_cuda.LAUNCHES == before + 1
        ref = greens_freq_cuda.freq_gemm_plain(q1, w1, q2, w2, k0=40, F=300, att=att)
        assert got.shape == ref.shape == (300, 130, 70)
        assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_das_on_card(card):
    xdc = qt.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=16),
        scan=qt.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 32),
                              z=np.linspace(16e-3, 24e-3, 32)))
    target = np.array([0.0, 0.0, 20e-3])
    scat = qt.Scatterers(pos=target[:, None], c0=1540.0)
    k1, k3 = das_cuda.LAUNCHES, greens_freq_cuda.LAUNCHES
    chd = us.greens(scat, device=card)  # 'auto': the freq engine, K3
    b = us.DAS(chd)                     # complex analytic traces, K1
    assert (das_cuda.LAUNCHES, greens_freq_cuda.LAUNCHES) == (k1 + 1, k3 + 1)
    assert chd.data.is_cuda and chd.data.is_complex() and b.is_cuda
    chd_ref = us.greens(scat, device=card, kernel="plain")
    ref = us.DAS(chd_ref, kernel="plain")
    assert (das_cuda.LAUNCHES, greens_freq_cuda.LAUNCHES) == (k1 + 1, k3 + 1)
    assert float((chd.data - chd_ref.data).abs().max()) \
        < 1e-4 * float(chd_ref.data.abs().max())
    assert float((b - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    P = us.scan.positions().reshape(3, -1)
    assert np.linalg.norm(P[:, int(b.abs().reshape(-1).argmax())] - target) < 1.1e-3
    # streamed through the card from host-resident traces
    bs = us.DAS(chd.replace(data=chd.data.cpu()), bsize=5, device=card)
    assert float((bs - b).abs().max()) < 1e-4 * float(b.abs().max())
    rf = chd.replace(data=chd.data.real.contiguous())
    for data, kw in ((chd, dict(fmod=3e6)), (rf, dict(keep_rx=True)),
                     (rf, dict(keep_tx=True)),
                     (rf, dict(apod=np.ones((1, 1, 1, 16, 1)))),
                     (rf, dict(precision="i8x4"))):
        with pytest.raises(NotImplementedError):
            us.DAS(data, **kw)
    # a per-pixel sound speed rides K2; a constant map is the scalar-c image
    k2 = das_cuda.LUT_LAUNCHES
    bc = us.DAS(chd, c0=np.full(us.scan.shape, 1540.0))
    assert das_cuda.LUT_LAUNCHES == k2 + 1
    assert float((bc - b).abs().max()) < 1e-4 * float(b.abs().max())


def lut_problem(T=512, N=32, M=8, n=64, cplx=False):
    """Geometric plane-wave tables plus a seeded perturbation of up to +-2
    samples, and t0 that puts some delays below 0 and some above T-1."""
    x, pi, pr, pv, nv, t0 = problem("plane", T=T, N=N, M=M, n=n)
    if cplx:
        x = (x + 1j * np.random.default_rng(42).standard_normal(x.shape)).astype(np.complex64)
    fs = 4e6
    rng = np.random.default_rng(43)
    tau_rx = (np.linalg.norm(pi[:, None] - pr[None], axis=-1) / 1540.0
              + rng.uniform(-2, 2, (pi.shape[0], N)) / fs).astype(np.float32)
    tau_tx = (pi @ nv.T / 1540.0
              + rng.uniform(-2, 2, (pi.shape[0], M)) / fs).astype(np.float32)
    return x, tau_rx, tau_tx, t0, fs


@pytest.mark.cuda
@pytest.mark.parametrize("cplx", [False, True])
def test_k2_matches_plain(card, cplx):
    x, tau_rx, tau_tx, t0, fs = lut_problem(cplx=cplx)
    xg = torch.as_tensor(x, device=card)
    for method in METHODS:
        before = das_cuda.LUT_LAUNCHES
        got = das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, fs=fs, method=method)
        torch.cuda.synchronize()
        assert das_cuda.LUT_LAUNCHES == before + 1
        ref = das_cuda.das_lut_sum_plain(xg, tau_rx, tau_tx, t0, fs=fs, method=method)
        assert got.dtype == ref.dtype == xg.dtype and got.shape == ref.shape
        assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max()), method


def adjoint_problem(T=128, N=12, M=10, V=9, I=300, seed=44):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, V)).astype(np.float32)
    tau_rx = rng.uniform(0, 2e-6, (I, N)).astype(np.float32)
    tau_tx = rng.uniform(0, 2e-6, (I, M)).astype(np.float32)
    del_tx = rng.uniform(0, 3e-7, (M, V)).astype(np.float32)
    apod = rng.standard_normal((M, V)).astype(np.float32)
    t0 = rng.uniform(0, 1e-6, (V,)).astype(np.float32)
    t0o = rng.uniform(0, 1e-7, (V,)).astype(np.float32)
    return x, tau_rx, tau_tx, del_tx, apod, t0, t0o


@pytest.mark.cuda
@pytest.mark.parametrize("V", [5, 40, 200])
@pytest.mark.parametrize("keep", ["", "rx", "tx"])
def test_k4_matches_plain(card, keep, V):
    x, *rest = adjoint_problem(V=V)
    xg = torch.as_tensor(x, device=card)
    bins = np.array([5, 9, 10, 11, 17, -1, 30], np.int32)
    kw = dict(fs=40e6, fmod=1e6, keep_rx=keep == "rx", keep_tx=keep == "tx")
    for precision, tol in (("f32", 1e-4), ("bf16", 2e-3)):
        before = fdbf_cuda.LAUNCHES
        got = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, precision=precision, **kw)
        torch.cuda.synchronize()
        assert fdbf_cuda.LAUNCHES == before + 1
        ref = bf_adjoint(xg, *rest, bins, precision=precision, **kw)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert float((got - ref).abs().max()) < tol * float(ref.abs().max()), precision
    empty = fdbf_cuda.bf_adjoint_cuda(xg, *rest, np.zeros(0, np.int32), **kw)
    assert empty.shape == got.shape and not bool(empty.abs().any())
    wide = torch.zeros((64, 12, 300), device=card)  # 300 pulses: K4(b)
    with pytest.raises(NotImplementedError, match="K4\\(b\\)"):
        fdbf_cuda.bf_adjoint_cuda(wide, rest[0], rest[1], np.zeros((10, 300)),
                                  np.ones((10, 300)), 0.0, np.zeros(300), bins, fs=40e6)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [5, 128])
@pytest.mark.parametrize("keep", ["", "rx", "tx"])
def test_k4_tensor_cores_at_main_shapes(card, keep, V):
    """K4 at the arrays of the main path (128 receivers, 128 elements): the
    bf16 variant on the tensor cores (< 2e-3) and f32 (< 1e-4) against the
    plain version, V = 5 (the demo, 10 columns padded to 16) and V = 128;
    two launches on one input are bit-identical."""
    x, *rest = adjoint_problem(T=256, N=128, M=128, V=V, I=700, seed=47)
    xg = torch.as_tensor(x, device=card)
    bins = np.arange(20, 44, dtype=np.int32)
    kw = dict(fs=40e6, keep_rx=keep == "rx", keep_tx=keep == "tx")
    for precision, tol in (("f32", 1e-4), ("bf16", 2e-3)):
        got = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, precision=precision, **kw)
        again = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, precision=precision, **kw)
        ref = bf_adjoint(xg, *rest, bins, precision=precision, **kw)
        assert float((got - ref).abs().max()) < tol * float(ref.abs().max()), precision
        assert torch.equal(got, again), precision


@pytest.mark.cuda
@pytest.mark.parametrize("keep", ["", "rx", "tx"])
def test_k4_per_chunk_phasors(card, keep):
    """Arrays whose phasor tiles do not fit in shared memory (M = 900):
    the bf16 variant builds each chunk's phasors as it goes. The transmit
    tile alone, 64 px x (2 * 912 + 8) bf16, is 234,496 bytes, above the
    232,448 a Hopper block may opt into."""
    x, *rest = adjoint_problem(T=128, N=200, M=900, V=24, I=130, seed=48)
    assert 64 * (2 * fdbf_cuda.tc_layout(900, 200, 24, keep)[1] + 8) * 2 > 232448
    xg = torch.as_tensor(x, device=card)
    bins = np.array([7, 9, 12], np.int32)
    kw = dict(fs=40e6, keep_rx=keep == "rx", keep_tx=keep == "tx", precision="bf16")
    got = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, **kw)
    ref = bf_adjoint(xg, *rest, bins, **kw)
    assert float((got - ref).abs().max()) < 2e-3 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 4])
def test_k3_bf16_tensor_cores(card, E):
    """K3(b) on the tensor cores against the bf16 plain version (< 2e-4) at
    the main arrays' 128 x 128 (one tile per bin) and with 4 sub-elements
    (too many to stage: the phasors read global memory); K3(a) against the
    same reference fails the limit (the control); two launches of each are
    bit-identical."""
    rng = np.random.default_rng(49)
    S = 1000
    ps = np.stack([rng.uniform(-8e-3, 8e-3, S), np.zeros(S), rng.uniform(8e-3, 30e-3, S)], -1)
    pe = np.stack([np.linspace(-10e-3, 10e-3, 128), np.zeros(128), np.zeros(128)], -1)
    pe = pe[:, None] + np.arange(E)[None, :, None] * np.array([5e-5, 0, 0])
    phc = np.float32(2 * np.pi / 1540.0 * 20e6 / 4096)
    ops = prologue(phc, ps, rng.standard_normal(S), pe, pe, R0=2e-4, fsr=1.0, device=card)
    kw = dict(k0=300, F=64, bf16=True)
    got = greens_freq_cuda.freq_gemm(*ops, **kw)
    assert torch.equal(got, greens_freq_cuda.freq_gemm(*ops, **kw))
    ref = greens_freq_cuda.freq_gemm_plain(*ops, **kw)
    assert float((got - ref).abs().max()) < 2e-4 * float(ref.abs().max())
    f32 = greens_freq_cuda.freq_gemm(*ops, **dict(kw, bf16=False))
    assert torch.equal(f32, greens_freq_cuda.freq_gemm(*ops, **dict(kw, bf16=False)))
    assert float((f32 - ref).abs().max()) > 2e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_plane_wave_path_on_card(card):
    """greens → focusTx (freq) → DAS (K1), bfDAS and per-pixel-c DAS (K2),
    bfAdjoint (K4) on a small plane-wave system, each against the same call
    with kernel='plain', and each image's peak on the target."""
    xdc = qt.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=qt.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]), c0=1540.0),
        scan=qt.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 32),
                              z=np.linspace(16e-3, 24e-3, 32)))
    target = np.array([0.0, 0.0, 20e-3])
    chd = us.greens(qt.Scatterers(pos=target[:, None], c0=1540.0), device=card)
    assert chd.data.is_cuda and chd.M == 3
    cmap = np.full(us.scan.shape, 1540.0)
    P = us.scan.positions().reshape(3, -1)
    calls = {"DAS": (lambda **k: us.DAS(chd, **k), 1e-4),
             "bfDAS": (lambda **k: us.bfDAS(chd, **k), 1e-4),
             "DAS c0 map": (lambda **k: us.DAS(chd, c0=cmap, **k), 1e-4),
             "bfAdjoint": (lambda **k: us.bfAdjoint(chd, **k), 2e-3),
             "bfAdjoint f32": (lambda **k: us.bfAdjoint(chd, precision="f32", **k), 1e-4)}
    counts = (das_cuda.LAUNCHES, das_cuda.LUT_LAUNCHES, fdbf_cuda.LAUNCHES)
    for name, (fn, tol) in calls.items():
        b, ref = fn(), fn(kernel="plain")
        assert b.is_cuda and b.shape == ref.shape
        assert float((b - ref).abs().max()) < tol * float(ref.abs().max()), name
        k = int(b.abs().reshape(-1).argmax())
        assert np.linalg.norm(P[:, k] - target) < 1.1e-3, name
    assert (das_cuda.LAUNCHES, das_cuda.LUT_LAUNCHES, fdbf_cuda.LAUNCHES) == \
        (counts[0] + 1, counts[1] + 2, counts[2] + 2)
    rf = chd.replace(data=chd.data.real.contiguous())
    for fn in (lambda: us.bfDAS(chd, fmod=3e6), lambda: us.bfDAS(rf.replace(data=rf.data[..., None])),
               lambda: us.bfDAS(chd, keep_rx=True), lambda: us.bfDAS(chd, keep_tx=True),
               lambda: us.bfDAS(chd, apod=np.ones((1, 1, 1, 16, 1))),
               lambda: us.bfDAS(rf, precision="bf16pair")):
        with pytest.raises(NotImplementedError, match="K2"):
            fn()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("directivity", [False, True], ids=["plain", "sinc"])
def test_k3_variants_match_plain(card, directivity, bf16):
    """K3(b) (bf16 operands) and K3(c) (sinc directivity) against the plain
    version at bf16 and f32: 130 x 70 elements leave partial tiles. K3(b)'s
    limit, 2e-4, is one that K3(a) against the bf16 plain version fails."""
    from qups_tpu_torch.ops.simus import simus_prologue

    rng = np.random.default_rng(45)
    S = 300
    ps = np.stack([rng.uniform(-5e-3, 5e-3, S), np.zeros(S), rng.uniform(10e-3, 30e-3, S)], -1)
    pn = np.stack([np.linspace(-10e-3, 10e-3, 130), np.zeros(130), np.zeros(130)], -1)
    pv = pn[:70]
    q1, w1, s1, q2, w2, s2 = simus_prologue(ps, rng.uniform(0.5, 1.5, S), pn, np.zeros(130),
                                            pv, np.zeros(70), [0.3e-3, 0.3e-3],
                                            np.float32(20e6 / (4096 * 1540.0)),
                                            baffle="soft", device=card)
    kw = dict(k0=40, F=300, bf16=bf16, att=1e-3,
              **(dict(s1=s1, s2=s2) if directivity else {}))
    before = greens_freq_cuda.LAUNCHES
    got = greens_freq_cuda.freq_gemm(q1, w1, q2, w2, **kw)
    torch.cuda.synchronize()
    assert greens_freq_cuda.LAUNCHES == before + 1
    ref = greens_freq_cuda.freq_gemm_plain(q1, w1, q2, w2, **kw)
    tol = 2e-4 if bf16 else 1e-4
    assert float((got - ref).abs().max()) < tol * float(ref.abs().max())
    if bf16:  # the control: float32 operands are told apart from bf16 ones
        f32 = greens_freq_cuda.freq_gemm(q1, w1, q2, w2, **dict(kw, bf16=False))
        assert float((f32 - ref).abs().max()) > tol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("case", ["real", "complex_kernel", "subelements"])
def test_k5_matches_plain(card, case, method):
    """K5's grid against splat_plain on the same plan (several rx lane
    blocks, partial tile blocks), then greens_tiled's traces through K5
    against kernel='plain'."""
    from qups_tpu_torch.ops.greens_cuda import greens_tiled, plan_tiled

    rng = np.random.default_rng(46)
    S, N, M, fs, c0, K = 700, 150, 6, 30e6, 1540.0, 41
    kern = (np.hanning(K) * np.sin(2 * np.pi * 5e6 * np.arange(K) / fs)).astype(np.float32)
    if case == "complex_kernel":
        kern = kern * np.exp(1j * np.linspace(0, 2, K)).astype(np.complex64)
    ps = np.stack([rng.uniform(-8e-3, 8e-3, S), np.zeros(S), rng.uniform(8e-3, 30e-3, S)], -1)
    amp = rng.uniform(0.5, 1.5, S)
    pn = np.stack([np.linspace(-15e-3, 15e-3, N), np.zeros(N), np.zeros(N)], -1)[:, None]
    pv = np.stack([np.linspace(-5e-3, 5e-3, M), np.zeros(M), np.zeros(M)], -1)[:, None]
    if case == "subelements":
        pn = np.concatenate([pn - [1e-4, 0, 0], pn + [1e-4, 0, 0]], axis=1)
    kw = dict(T=1200, s0=2 * 7e-3 / c0, t0k=-K / 2 / fs, fs=fs, cinv=1 / c0, R0=3e-4,
              method=method, CS=128)
    plan = plan_tiled(kern, ps, amp, pn, pv, **kw)
    t = {k: torch.as_tensor(plan[k], device=card) for k in ("lo", "nc", "scat", "ofs_pad")}
    args = (t["lo"], t["nc"], t["scat"], torch.as_tensor(plan["pn"][-1], device=card),
            t["ofs_pad"], torch.as_tensor(plan["pv"][0], device=card))
    before = greens_cuda.LAUNCHES
    got = greens_cuda.splat(*args, **plan["st"])
    torch.cuda.synchronize()
    assert greens_cuda.LAUNCHES == before + 1
    ref = greens_cuda.splat_plain(*args, **plan["st"])
    assert got.shape == ref.shape and got.shape[2] == 256
    assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    again = greens_cuda.splat(*args, **plan["st"])
    assert torch.equal(again, got)  # no atomics: runs repeat bit for bit
    x = greens_tiled(kern, ps, amp, pn, pv, device=card, **kw)
    xp = greens_tiled(kern, ps, amp, pn, pv, device=card, kernel="plain", **kw)
    assert x.is_cuda and x.dtype == xp.dtype and x.shape == (1200, N, M)
    assert float((x - xp).abs().max()) < 1e-4 * float(xp.abs().max())


@pytest.mark.cuda
def test_simulators_on_card(card):
    """The simulator family through the port's entry points on CUDA tensors,
    each against kernel='plain': greens pallas (K5) and bf16 (K3(b)), simus
    (K3(c)) with both baffles, calc_scat_multi blocked vs fused, calc_hp."""
    xdc = qt.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=16),
        scan=qt.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 32),
                              z=np.linspace(16e-3, 24e-3, 32)))
    target = np.array([0.0, 0.0, 20e-3])
    scat = qt.Scatterers(pos=target[:, None], c0=1540.0)
    P = us.scan.positions().reshape(3, -1)
    calls = {"pallas": (dict(impl="pallas"), greens_cuda, 1e-4),
             "bf16": (dict(precision="bf16"), greens_freq_cuda, 2e-4)}
    for name, (kw, mod, tol) in calls.items():
        before = mod.LAUNCHES
        chd = us.greens(scat, device=card, **kw)
        assert mod.LAUNCHES == before + 1, name
        ref = us.greens(scat, device=card, kernel="plain", **kw)
        assert float((chd.data - ref.data).abs().max()) < tol * float(ref.data.abs().max())
        if name == "bf16":  # the control: K3(a)'s traces fail K3(b)'s limit
            f32 = us.greens(scat, device=card).data
            assert float((f32 - ref.data).abs().max()) > tol * float(ref.data.abs().max())
        b = us.DAS(chd)
        assert np.linalg.norm(P[:, int(b.abs().reshape(-1).argmax())] - target) < 1.1e-3
    for baffle in ("soft", "hard"):
        before = greens_freq_cuda.LAUNCHES
        chd = us.simus(scat, baffle=baffle, device=card)
        assert greens_freq_cuda.LAUNCHES == before + 1 and chd.data.is_cuda
        ref = us.simus(scat, baffle=baffle, device=card, kernel="plain")
        assert float((chd.data - ref.data).abs().max()) < 1e-4 * float(ref.data.abs().max())
    pw = us.replace(seq=qt.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]),
                                          c0=1540.0))
    a = pw.calc_scat_multi(scat, impl="pallas", device=card)
    b = pw.calc_scat_multi(scat, impl="pallas", device=card, bsize=1)
    assert a.data.is_cuda and float((a.data - b.data).abs().max()) \
        < 1e-5 * float(a.data.abs().max())
    fc = us.replace(seq=qt.Sequence(type="FC", focus=target[:, None], c0=1540.0))
    hp = fc.calc_hp(device=card)
    hpc = fc.calc_hp(device="cpu")
    assert hp.is_cuda and float((hp.cpu() - hpc).abs().max()) < 1e-4 * float(hpc.max())
