"""Kernels K1-K5 on a CUDA card: K1 against its plain PyTorch version for
every transmit model and sampler, real and complex; K2 against das_lut for
every sampler, real and complex; both with frames and IQ remodulation
(K1(b), K2(b)), and the layout kernel with frames; both at the
receiver-chunk and pixel-block edges, with delays exactly on 0 and T-1,
and two launches bit-identical;
K1 and K2 by chunks of transmits, and K1's layout footprint at its limit;
the layout kernel against its plain version; K3 against its plain
version, with its bf16 operands on the tensor cores (K3(b)) and its sinc
directivity (K3(c)); K4 against bf_adjoint for every keep mode and
precision, at the main arrays' shapes and with the phasors built per
chunk; two launches of K3(b) and K4 bit-identical; K5 against splat_plain
for both bases, sub-elements and a complex kernel; the sim→image path
greens → DAS, the plane-wave path greens → focusTx → DAS / bfDAS /
per-pixel-c DAS / bfAdjoint and the simulator family (greens pallas and
bf16, simus, calc_scat_multi, calc_hp) on CUDA tensors; the reduced
trace precisions of K1(e) and K2(e) (the layout kernel's narrow entries bit
for bit, the kernels against their plain versions at each precision, keep
modes and weights, the bfloat16 kept sums of QUPS_DAS_ACC16); K4(b), K4
past 256 pulses and keep_rx receivers, with conj(Ahat) in one pass and by
chunks; bfEikonal's tables and K2 on the card; and the modules without a
TPU kernel that run on the card by default: refocus (every method) and its
spectral norm, Stolt migration and bfMigration, the ray path integrals'
device path, the k-space steppers and kspaceFirstOrder, each against its
own device="cpu" run; and the sharded functions on four shards of the
card ([cuda:0] * 4: das_sharded_pallas summed, bf16pair, keep_rx and the
in-mesh coherence, greens_freq_sharded, bf_adjoint_sharded) against their
single-device calls, each kernel launched once per shard; and the
benchmark entry points (qups_tpu_torch.bench, .benches) at their small
sizes; and the JAX-named kernel-level entry points (das_tiled,
das_lut_tiled, das_lut_plan, prep_sharded, prep_lut_sharded,
bf_adjoint_tiled, freq_gemm_cuda, simus_spectrum_cuda) against the methods
that make the same launches. Every test here needs the card and skips
without one.

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
    # keep modes and apodization run on K1(c)/(d), against kernel='plain'
    for kw in (dict(keep_rx=True), dict(keep_tx=True), dict(keep_rx=True, keep_tx=True),
               dict(apod=np.linspace(0.5, 1.5, 16).reshape(1, 1, 1, 16, 1)),
               dict(apod=qt.Fused("aperture_growth", f=1.5), keep_rx=True)):
        counts = das_cuda.KEEP_LAUNCHES, das_cuda.APOD_LAUNCHES
        got = us.DAS(rf, **kw)
        torch.cuda.synchronize()
        assert das_cuda.KEEP_LAUNCHES == counts[0] + int("keep_rx" in kw or "keep_tx" in kw)
        assert das_cuda.APOD_LAUNCHES == counts[1] + int("apod" in kw)
        ref = us.DAS(rf, kernel="plain", **kw)
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max()), kw
    # the trace precisions run on K1(e), against its plain version at the
    # same precision; i8x4 refuses cubic2x (linear), as the TPU kernel does
    pvs, nvs, model = us._tx_geometry()
    geo = (us._pixels(), us.rx.positions().T, pvs, nvs, rf.t0, np.float32(1 / 1540.0))
    for precision in ("bf16pair", "bf16", "i8x4"):
        before = das_cuda.PREC_LAUNCHES, das_cuda.LAUNCHES
        got = us.DAS(rf, precision=precision)
        torch.cuda.synchronize()
        assert (das_cuda.PREC_LAUNCHES, das_cuda.LAUNCHES) == (before[0] + 1, before[1])
        ref = das_cuda.das_sum_plain(rf.data, *geo, fs=float(rf.fs), tx_model=model,
                                     method="cubic", precision=precision)
        assert float((got.reshape(ref.shape) - ref).abs().max()) \
            < 1e-4 * float(ref.abs().max()), precision
        assert np.linalg.norm(P[:, int(got.abs().reshape(-1).argmax())] - target) < 1.1e-3
    with pytest.raises(ValueError, match="4-tap"):
        us.DAS(rf, precision="i8x4", method="cubic2x")
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


def edge_problem(N, M, I, T=64, seed=47):
    """Unit-free delays (cinv = fs = 1, so ti is a distance in samples)
    that land exactly on 0 and T-1, and fall below 0 and beyond T-1.
    Geometry for K1: receivers on x in +-20, pixels on x in +-20, z in
    0-40; transmit 0 a straight plane wave (dv = z), the others tilted up
    to 20 deg. Pixel 0 lies on receiver 0 (ti = 0 there for transmit 0),
    pixel 1 at z = (T-1)/2 under receiver N-1 (ti = T-1). Tables for K2:
    multiples of 1/4 (sums exact in float32), with the same two exact
    terms."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    pr = np.stack([np.linspace(-20, 20, N), np.zeros(N), np.zeros(N)], -1).astype(np.float32)
    pi = np.stack([rng.uniform(-20, 20, I), np.zeros(I), rng.uniform(0, 40, I)],
                  -1).astype(np.float32)
    pi[0] = pr[0]
    if I > 1:
        pi[1] = (pr[-1, 0], 0.0, (T - 1) / 2)
    th = np.radians(np.linspace(0, 20, M))
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1).astype(np.float32)
    pv = np.zeros((M, 3), np.float32)
    tau_rx = (rng.integers(-8, 4 * T + 8, (I, N)) / 4).astype(np.float32)
    tau_tx = (rng.integers(-8, 8, (I, M)) / 4).astype(np.float32)
    tau_rx[0, 0], tau_tx[0, 0] = 0.0, 0.0
    if I > 1:
        tau_rx[1, -1], tau_tx[1, 0] = T - 1, 0.0
    return x, pi, pr, pv, nv, tau_rx, tau_tx


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,I", [(100, 1, 1000), (257, 3, 300), (31, 2, 1)])
def test_k1_k2_chunk_edges_and_repeats(card, N, M, I):
    """K1 and K2 against their plain versions where N is not a multiple of
    the receiver chunk (32), I not a multiple of the block (256), M = 1, and
    delays land exactly on 0 and T-1 (edge taps read from the layouts with
    no clamp); for every sampler, real and complex traces. Two launches
    give the same bits (no atomics)."""
    x, pi, pr, pv, nv, tau_rx, tau_tx = edge_problem(N, M, I)
    T = x.shape[0]
    for cplx in (False, True):
        xc = (x * np.exp(1j * np.linspace(0, 6, T))[:, None, None]).astype(np.complex64)
        xg = torch.as_tensor(xc if cplx else x, device=card)
        k1_args, k2_args = (xg, pi, pr, pv, nv, 0.0, 1.0), (xg, tau_rx, tau_tx, 0.0)
        for method in METHODS:
            calls = ((das_cuda.das_sum, das_cuda.das_sum_plain, k1_args,
                      dict(fs=1.0, tx_model="plane", method=method)),
                     (das_cuda.das_lut_sum, das_cuda.das_lut_sum_plain, k2_args,
                      dict(fs=1.0, method=method)))
            for kern, plain, args, kw in calls:
                before = (das_cuda.LAUNCHES, das_cuda.LUT_LAUNCHES)
                got = kern(*args, **kw)
                again = kern(*args, **kw)
                torch.cuda.synchronize()
                assert das_cuda.LAUNCHES + das_cuda.LUT_LAUNCHES == sum(before) + 2
                ref = plain(*args, **kw)
                assert got.shape == ref.shape == (I, 1, 1) and got.dtype == xg.dtype
                assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max()), \
                    (kern.__name__, method, cplx)
                assert torch.equal(got, again), (kern.__name__, method, cplx)


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,M", [(1, 3, 2), (2, 1, 33), (3, 2, 1), (130, 5, 40)])
def test_layout_kernel_matches_plain(card, T, N, M):
    """The layout kernel against trace_layout_plain, bit for bit, for every
    sampler's layout, real and complex: trace lengths and transmit counts
    that leave partial tiles (64 entries x 32 transmits), and traces of 1-3
    samples, whose taps are all edge replicas."""
    rng = np.random.default_rng(48)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    for xa in (x, (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)):
        xg = torch.as_tensor(xa, device=card)
        for method in METHODS:
            before = das_cuda.LAYOUT_LAUNCHES
            got = das_cuda.trace_layout(xg, method)
            torch.cuda.synchronize()
            assert das_cuda.LAYOUT_LAUNCHES == before + 1
            ref = das_cuda.trace_layout_plain(xg, method)
            assert got.shape == ref.shape and got.dtype == ref.dtype
            assert torch.equal(got, ref), (method, xa.dtype)
            # a chunk of transmits, as K1 and K2 lay them out by chunks
            m0, m1 = M // 3, M - M // 4
            got = das_cuda.trace_layout(xg, method, m0, m1)
            assert torch.equal(got, das_cuda.trace_layout_plain(xg[..., m0:m1], method))


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", ["one transmit each", "three", "four of two"])
def test_k1_k2_by_transmit_chunks(card, chunks, monkeypatch):
    """K1 and K2 with LAYOUT_BYTES cut so that they lay out and sum the
    transmits by chunks, each launch adding to the last: one launch of each
    kernel per chunk, the image against the plain version and the one-chunk
    image within 1e-4, and two calls bit-identical; every sampler, real and
    complex traces."""
    x, tau_rx, tau_tx, t0, fs = lut_problem(M=8, n=32)
    _, pi, pr, pv, nv, _ = problem("plane", M=8, n=32)
    T, N, M = x.shape
    for cplx in (False, True):
        xa = (x * np.exp(1j * np.linspace(0, 6, T))[:, None, None]).astype(np.complex64) \
            if cplx else x
        xg = torch.as_tensor(xa, device=card)
        for method in METHODS:
            per_tx = das_cuda.trace_layout(xg, method, 0, 1).numel() * (
                8 if method == "nearest" and cplx else 4)
            budget, k = {"one transmit each": (per_tx - 1, M), "three": (3 * per_tx, 3),
                         "four of two": (3 * per_tx - 1, 4)}[chunks]
            whole = (das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, fs=fs, tx_model="plane",
                                      method=method),
                     das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, fs=fs, method=method))
            monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", budget)
            assert len(das_cuda.tx_chunks(xg, method)) == k
            for kern, plain, args, kw, one in (
                    (das_cuda.das_sum, das_cuda.das_sum_plain, (xg, pi, pr, pv, nv, t0, CINV),
                     dict(fs=fs, tx_model="plane", method=method), whole[0]),
                    (das_cuda.das_lut_sum, das_cuda.das_lut_sum_plain,
                     (xg, tau_rx, tau_tx, t0), dict(fs=fs, method=method), whole[1])):
                before = (das_cuda.LAUNCHES, das_cuda.LUT_LAUNCHES, das_cuda.LAYOUT_LAUNCHES)
                got = kern(*args, **kw)
                torch.cuda.synchronize()
                assert (das_cuda.LAUNCHES + das_cuda.LUT_LAUNCHES - before[0] - before[1],
                        das_cuda.LAYOUT_LAUNCHES - before[2]) == (k, k)
                assert torch.equal(got, kern(*args, **kw)), (kern.__name__, method, cplx)
                ref = plain(*args, **kw)
                for want in (ref, one):
                    assert float((got - want).abs().max()) < 1e-4 * float(ref.abs().max()), \
                        (kern.__name__, method, cplx)
            monkeypatch.undo()


@pytest.mark.cuda
def test_k1_layout_footprint_at_the_limit(card):
    """Real traces of 4096 samples x 256 receivers x 260 transmits, whose
    cubic stencil (4.06 GiB) just exceeds LAYOUT_BYTES (4 GiB): K1 lays
    them out in two chunks, and the call's peak device memory above the
    traces and geometry stays within LAYOUT_BYTES plus the output. The image
    of a few pixels against the plain version."""
    T, N, M, I = 4096, 256, 260, 256
    g = torch.Generator(device=card).manual_seed(49)
    xg = torch.randn((T, N, M), generator=g, device=card)
    _, pi, pr, pv, nv, t0 = problem("plane", N=N, M=M, n=16)
    pg = [torch.as_tensor(a, device=card) for a in (pi, pr, pv, nv, t0)]
    assert das_cuda.tx_chunks(xg, "cubic") == [(0, 130), (130, 260)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    before = das_cuda.LAUNCHES
    got = das_cuda.das_sum(xg, *pg[:4], pg[4], CINV, fs=20e6, tx_model="plane",
                           method="cubic")
    torch.cuda.synchronize()
    assert das_cuda.LAUNCHES == before + 2
    peak = torch.cuda.max_memory_allocated(card) - base
    assert peak <= das_cuda.LAYOUT_BYTES + 8 * I + (1 << 20), peak
    ref = das_cuda.das_sum_plain(xg, *pg[:4], pg[4], CINV, fs=20e6, tx_model="plane",
                                 method="cubic")
    assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())


# K1(b) and K2(b): (complex traces, fmod)
IQ = {"real_fmod": (False, 1e6), "complex_fmod": (True, 1e6), "complex": (True, 0.0)}
FRAMES = {"F1": (1,), "F3": (3,), "F6": (6,), "F2x3": (2, 3)}


def frame_traces(x, fdims, cplx, seed=60):
    """Traces (T, N, M, *fdims) on the card: frame 0 is ``x``, the others
    seeded draws; complex with a random imaginary part."""
    rng = np.random.default_rng(seed)
    xf = rng.standard_normal(x.shape + tuple(fdims)).astype(np.float32)
    if cplx:
        xf = (xf + 1j * rng.standard_normal(xf.shape)).astype(np.complex64)
    xf.reshape(x.shape + (-1,))[..., 0] = x
    return torch.as_tensor(xf)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", sorted(FRAMES))
@pytest.mark.parametrize("iq", sorted(IQ))
def test_k1b_k2b_match_plain(card, iq, frames):
    """K1(b) and K2(b): frames (F = 1, 3, 6 (a ragged block of 4) and dims
    (2, 3)) and remodulation, real traces with fmod (complex sums), complex
    with and without, for every sampler and (K1) transmit model, delays off
    both ends of the traces, against their plain versions: one launch per
    block of 4 frames, and the image (I, 1, 1, *F)."""
    cplx, fmod = IQ[iq]
    fdims = FRAMES[frames]
    blocks = -(-int(np.prod(fdims)) // das_cuda.FB)
    x, tau_rx, tau_tx, t0, fs = lut_problem()
    xf = frame_traces(x, fdims, cplx).to(card)
    calls = [(das_cuda.das_lut_sum, das_cuda.das_lut_sum_plain, (xf, tau_rx, tau_tx, t0),
              dict(fs=fs), "LUT_LAUNCHES")]
    for model in ("plane", "diverging", "virtual"):
        _, pi, pr, pv, nv, t0m = problem(model)
        calls.append((das_cuda.das_sum, das_cuda.das_sum_plain,
                      (xf, pi, pr, pv, nv, t0m, CINV), dict(fs=fs, tx_model=model),
                      "LAUNCHES"))
    for kern, plain, args, kw, counter in calls:
        for method in METHODS:
            kw = dict(kw, method=method, fmod=fmod)
            before = getattr(das_cuda, counter)
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            assert getattr(das_cuda, counter) == before + blocks
            ref = plain(*args, **kw)
            assert got.shape == ref.shape == (args[1].shape[0] if counter == "LUT_LAUNCHES"
                                              else 64 * 64, 1, 1) + fdims
            assert got.dtype == ref.dtype == (torch.complex64 if cplx or fmod
                                              else torch.float32)
            err = float((got - ref).abs().max()) / float(ref.abs().max())
            assert err < 1e-4, (kern.__name__, kw, iq, frames, err)


KEEPS = {"": {}, "rx": dict(keep_rx=True), "tx": dict(keep_tx=True),
         "both": dict(keep_rx=True, keep_tx=True)}


def _weights(kind, n=64, N=32, M=8):
    """The apodizations of the K1(c)/(d), K2(c) card tests: each fused kind
    alone, two mixed, a dense (I, N, 1) and a dense (1, X, 1, N, M)."""
    rng = np.random.default_rng(46)
    lat_tx = np.linspace(-9e-3, 9e-3, M)
    return {
        "none": (),
        "aperture_growth": (qt.Fused("aperture_growth", f=1.0, Dmax=15e-3),),
        "acceptance_angle": (qt.Fused("acceptance_angle", theta=35.0),),
        "tx_scanline": (qt.Fused("tx_scanline", tol=3e-3, lat_tx=lat_tx),),
        "tx_multiline": (qt.Fused("tx_multiline", dlat=3e-3, lat_tx=lat_tx),),
        "tx_parallelogram": (qt.Fused("tx_parallelogram", xlo=-8e-3, xhi=9e-3),),
        "mixed": (qt.Fused("acceptance_angle", theta=40.0),
                  qt.Fused("tx_parallelogram", xlo=-8e-3, xhi=9e-3)),
        "dense rx": (rng.uniform(0, 1, (n, n, 1, N, 1)).astype(np.float32),),
        "dense rx tx": (rng.uniform(0, 1, (1, n, 1, N, M)).astype(np.float32),),
    }[kind]


WEIGHTS = ("none", "aperture_growth", "acceptance_angle", "tx_scanline", "tx_multiline",
           "tx_parallelogram", "mixed", "dense rx", "dense rx tx")


@pytest.mark.cuda
@pytest.mark.parametrize("keep,weights", [(k, w) for k in sorted(KEEPS) for w in WEIGHTS
                                          if (k, w) != ("", "none")])
def test_k1c_k1d_match_plain(card, keep, weights):
    """K1(c) and K1(d): every keep mode x each fused kind alone, two mixed
    and dense weights, on real traces with fmod and on complex ones with 3
    frames, for the three transmit models and every sampler, against the
    plain version (fused_weights + das): one launch per block of frames
    (keep_rx: 2 real or 1 complex frames a launch, its sums in shared
    memory), the image (I, N', M', *F)."""
    apod = _weights(weights)
    az = np.radians(np.linspace(-8.0, 8.0, 32))
    ori = np.stack([np.sin(az), np.cos(az)])
    for model in ("plane", "diverging", "virtual"):
        x, pi, pr, pv, nv, t0 = problem(model)
        for xg, fmod in ((torch.as_tensor(x).to(card), 1e6),
                         (frame_traces(x, (3,), True).to(card), 0.0)):
            for method in METHODS:
                kw = dict(fs=4e6, tx_model=model, method=method, fmod=fmod, apod=apod,
                          im_shape=(64, 64, 1), orientations=ori, **KEEPS[keep])
                counts = das_cuda.KEEP_LAUNCHES, das_cuda.APOD_LAUNCHES
                got = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, **kw)
                torch.cuda.synchronize()
                assert das_cuda.KEEP_LAUNCHES - counts[0] == (
                    0 if keep == "" else (3 if keep == "rx" and xg.ndim == 4 else 1))
                assert (das_cuda.APOD_LAUNCHES > counts[1]) == bool(apod)
                ref = das_cuda.das_sum_plain(xg, pi, pr, pv, nv, t0, CINV, **kw)
                assert got.shape == ref.shape and got.dtype == ref.dtype
                err = float((got - ref).abs().max()) / float(ref.abs().max())
                assert err < 1e-4, (model, method, fmod, xg.ndim, err)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", sorted(KEEPS))
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_k2c_matches_plain(card, keep, cplx):
    """K2(c): every keep mode x (no weight, dense (I, N, 1), dense (1, X, 1,
    N, M)) on perturbed tables, real with fmod and complex with 3 frames,
    every sampler, against das_lut; a Fused descriptor raises TypeError."""
    x, tau_rx, tau_tx, t0, fs = lut_problem(cplx=cplx)
    xg = (frame_traces(x, (3,), True) if cplx else torch.as_tensor(x)).to(card)
    for weights in ("none", "dense rx", "dense rx tx"):
        if keep == "" and weights == "none":
            continue
        for method in METHODS:
            kw = dict(fs=fs, method=method, fmod=0.0 if cplx else 1e6,
                      apod=_weights(weights), im_shape=(64, 64, 1), **KEEPS[keep])
            before = das_cuda.LUT_KEEP_LAUNCHES
            got = das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw)
            torch.cuda.synchronize()
            assert das_cuda.LUT_KEEP_LAUNCHES > before
            ref = das_cuda.das_lut_sum_plain(xg, tau_rx, tau_tx, t0, **kw)
            assert got.shape == ref.shape and got.dtype == ref.dtype
            err = float((got - ref).abs().max()) / float(ref.abs().max())
            assert err < 1e-4, (weights, method, err)
    with pytest.raises(TypeError):
        das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, fs=fs, apod=_weights("aperture_growth"))


@pytest.mark.cuda
@pytest.mark.parametrize("keep", ["rx", "tx", "both"])
def test_keep_kernel_by_transmit_chunks_and_repeats(card, keep, monkeypatch):
    """das_keep_kernel across chunks of transmits (the layout budget cut to
    force 3) and across receiver chunks (N 70: 32 + 32 + 6) with 300
    pixels (a ragged block): the same image as in one chunk, within
    float32 rounding, and two launches bit-identical."""
    x, pi, pr, pv, nv, t0 = problem("virtual", N=70, M=9, n=20)
    pi = pi[:300]
    xg = torch.as_tensor(x).to(card)
    kw = dict(fs=4e6, tx_model="virtual", method="cubic", apod=_weights("acceptance_angle"),
              **KEEPS[keep])
    one = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, **kw)
    assert torch.equal(one, das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, **kw))
    monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", 3 * 4 * 4 * 512 * 70)
    assert len(das_cuda.tx_chunks(xg, "cubic")) == 3
    got = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, **kw)
    ref = das_cuda.das_sum_plain(xg, pi, pr, pv, nv, t0, CINV, **kw)
    assert float((got - one).abs().max()) <= 1e-5 * float(one.abs().max())
    assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,M,F", [(1, 3, 2, 3), (3, 2, 1, 5), (130, 5, 40, 3), (70, 2, 7, 9)])
def test_layout_kernel_frames_matches_plain(card, T, N, M, F):
    """The layout kernel with frames, (M, N, T, F, [2,] entry), against
    trace_layout_plain, bit for bit, for every sampler, real and complex,
    whole and by a chunk of transmits."""
    rng = np.random.default_rng(61)
    x = rng.standard_normal((T, N, M, F)).astype(np.float32)
    for xa in (x, (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)):
        xg = torch.as_tensor(xa, device=card)
        for method in METHODS:
            got = das_cuda.trace_layout(xg, method)
            ref = das_cuda.trace_layout_plain(xg, method)
            assert got.shape == ref.shape and torch.equal(got, ref), (method, xa.dtype)
            m0, m1 = M // 3, M - M // 4
            got = das_cuda.trace_layout(xg, method, m0, m1)
            assert torch.equal(got, das_cuda.trace_layout_plain(xg[:, :, m0:m1], method))


# K1(e), K2(e): each reduced precision and the samplers it takes
PREC_METHODS = {"bf16pair": METHODS, "bf16": METHODS, "i8x4": ("cubic", "lanczos3")}


def _lp_counts():
    return (das_cuda.PREC_LAUNCHES, das_cuda.LUT_PREC_LAUNCHES, das_cuda.LAUNCHES,
            das_cuda.LUT_LAUNCHES, das_cuda.KEEP_LAUNCHES, das_cuda.APOD_LAUNCHES,
            das_cuda.LUT_KEEP_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,M,F", [(1, 3, 2, 1), (3, 2, 1, 5), (130, 5, 40, 1), (70, 2, 7, 3)])
def test_layout_kernel_narrow_entries_match_plain(card, T, N, M, F):
    """The layout kernel's narrow entries against trace_layout_plain, bit
    for bit: bf16 taps rounded half away from zero ('bf16pair') and half to
    even ('bf16'), exact ties among them, and int8 taps with one scale per
    transmit (transmits 60 dB apart), every sampler each takes, real and
    complex, one frame and several, whole and by a chunk of transmits."""
    rng = np.random.default_rng(63)
    x = rng.standard_normal((T, N, M, F)).astype(np.float32)
    x *= np.logspace(0, -3, M, dtype=np.float32)[None, None, :, None]
    b = x.reshape(-1).view(np.int32)
    b[::5] = (b[::5] & ~0xFFFF) | 0x8000  # bf16 ties
    for xa in (x, (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)):
        xg = torch.as_tensor(xa, device=card)
        s = das_cuda.i8_scale(xg)
        for precision, methods in PREC_METHODS.items():
            sc = s if precision == "i8x4" else None
            for method in methods:
                before = das_cuda.LAYOUT_LAUNCHES
                got = das_cuda.trace_layout(xg, method, precision=precision, scale=sc)
                assert das_cuda.LAYOUT_LAUNCHES == before + 1
                ref = das_cuda.trace_layout_plain(xg, method, precision, sc)
                assert got.dtype == ref.dtype == (torch.int8 if sc is not None else torch.int16)
                assert got.shape == ref.shape and torch.equal(got, ref), (precision, method)
                m0, m1 = M // 3, M - M // 4
                got = das_cuda.trace_layout(xg, method, m0, m1, precision, sc)
                assert torch.equal(got, das_cuda.trace_layout_plain(
                    xg[:, :, m0:m1], method, precision, None if sc is None else sc[m0:m1]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["real"] + sorted(IQ))
@pytest.mark.parametrize("precision", sorted(PREC_METHODS))
def test_k1e_k2e_match_plain(card, precision, case):
    """K1(e) and K2(e) ('bf16' K1 only): every sampler the precision takes x
    the three transmit models and perturbed tables x one frame and 6 (two
    launches), real traces, real with fmod, complex with and without,
    against their plain versions: the same rounded taps, so within float32
    roundings. Each launch counts in PREC_LAUNCHES or LUT_PREC_LAUNCHES
    and in no float32 counter."""
    cplx, fmod = IQ.get(case, (False, 0.0))
    x, tau_rx, tau_tx, t0, fs = lut_problem()
    for fdims in ((), (6,)):
        xf = frame_traces(x, fdims, cplx).to(card)
        calls = [] if precision == "bf16" else [
            (das_cuda.das_lut_sum, das_cuda.das_lut_sum_plain, (xf, tau_rx, tau_tx, t0),
             dict(fs=fs), 1)]
        for model in ("plane", "diverging", "virtual"):
            _, pi, pr, pv, nv, t0m = problem(model)
            calls.append((das_cuda.das_sum, das_cuda.das_sum_plain,
                          (xf, pi, pr, pv, nv, t0m, CINV), dict(fs=fs, tx_model=model), 0))
        for kern, plain, args, kw, which in calls:
            for method in PREC_METHODS[precision]:
                kw = dict(kw, method=method, fmod=fmod, precision=precision)
                before = _lp_counts()
                got = kern(*args, **kw)
                torch.cuda.synchronize()
                delta = np.subtract(_lp_counts(), before)
                assert delta[which] == (2 if fdims else 1) and delta.sum() == delta[which]
                ref = plain(*args, **kw)
                assert got.shape == ref.shape and got.dtype == ref.dtype
                err = float((got - ref).abs().max()) / float(ref.abs().max())
                assert err < 1e-4, (kern.__name__, precision, method, case, fdims, err)


@pytest.mark.cuda
@pytest.mark.parametrize("keep,weights", [("rx", "none"), ("tx", "none"), ("both", "none"),
                                          ("", "mixed"), ("rx", "dense rx tx"),
                                          ("tx", "tx_multiline")])
@pytest.mark.parametrize("precision", ["bf16pair", "i8x4"])
def test_k1e_keep_and_weights_match_plain(card, precision, keep, weights):
    """K1(e) in the keep kernel: keep modes and weights (fused and dense) at
    a reduced precision, real traces with fmod and complex ones with 3
    frames, two transmit models, against the plain version; K2(e) keep_rx
    on the perturbed tables."""
    apod = _weights(weights)
    methods = ("cubic", "lanczos3") if precision == "i8x4" else ("nearest", "cubic")
    for model in ("plane", "virtual"):
        x, pi, pr, pv, nv, t0 = problem(model)
        for xg, fmod in ((torch.as_tensor(x).to(card), 1e6),
                         (frame_traces(x, (3,), True).to(card), 0.0)):
            for method in methods:
                kw = dict(fs=4e6, tx_model=model, method=method, fmod=fmod, apod=apod,
                          im_shape=(64, 64, 1), precision=precision, **KEEPS[keep])
                before = _lp_counts()
                got = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, **kw)
                torch.cuda.synchronize()
                delta = np.subtract(_lp_counts(), before)
                assert delta[0] > 0 and delta.sum() == delta[0]
                ref = das_cuda.das_sum_plain(xg, pi, pr, pv, nv, t0, CINV, **kw)
                assert got.shape == ref.shape and got.dtype == ref.dtype
                err = float((got - ref).abs().max()) / float(ref.abs().max())
                assert err < 1e-4, (model, method, fmod, xg.ndim, err)
    x, tau_rx, tau_tx, t0, fs = lut_problem()
    xg = torch.as_tensor(x).to(card)
    kw = dict(fs=fs, method="cubic", keep_rx=True, precision=precision)
    before = das_cuda.LUT_PREC_LAUNCHES
    got = das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw)
    assert das_cuda.LUT_PREC_LAUNCHES == before + 1
    ref = das_cuda.das_lut_sum_plain(xg, tau_rx, tau_tx, t0, **kw)
    assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("keep", ["rx", "tx", "both"])
@pytest.mark.parametrize("precision", ["f32", "bf16pair", "i8x4"])
def test_acc16_matches_plain(card, precision, keep, monkeypatch):
    """QUPS_DAS_ACC16=1: K1 stores its kept sums as bfloat16 (float32 traces
    through das_keep_acc16.cu), across 3 chunks of transmits and 3 of
    receivers (N 70), against the plain version, which rounds at the same
    stores. Every value is a bfloat16; a sum whose float32 value lies
    within rounding of a bfloat16 tie may round one step (2^-7 of its size
    at most) the other way at each of its k stores, so the limit is 1e-4 of
    the largest plus k 2^-7 of its own size, and such values are rare."""
    monkeypatch.setenv("QUPS_DAS_ACC16", "1")
    x, pi, pr, pv, nv, t0 = problem("virtual", N=70, M=9, n=20)
    pi = pi[:300]
    xg = torch.as_tensor(x).to(card)
    monkeypatch.setattr(das_cuda, "LAYOUT_BYTES",
                        3 * {"f32": 4, "bf16pair": 2, "i8x4": 1}[precision] * 4 * 512 * 70)
    assert len(das_cuda.tx_chunks(xg, "cubic", precision)) == 3
    kw = dict(fs=4e6, tx_model="virtual", method="cubic", precision=precision, **KEEPS[keep])
    before = _lp_counts()
    got = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, **kw)
    torch.cuda.synchronize()
    delta = np.subtract(_lp_counts(), before)
    assert delta[0] == 3 and delta.sum() == 3
    ref = das_cuda.das_sum_plain(xg, pi, pr, pv, nv, t0, CINV, **kw)
    assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got, das_cuda.round_bf16_even(got))
    k = {"rx": 3, "tx": 3, "both": 1}[keep]
    off = (got - ref).abs() - 1e-4 * float(ref.abs().max())
    assert bool((off <= k * 2.0 ** -7 * ref.abs()).all())
    assert float((off > 0).float().mean()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("keep", ["rx", "tx", "both"])
@pytest.mark.parametrize("precision", ["f32", "bf16pair"])
def test_acc16_frames_complex_match_plain(card, precision, keep, monkeypatch):
    """QUPS_DAS_ACC16=1 on complex traces remodulated at fmod, 6 frames in
    launches of at most FB frames: the kept sums stored as pairs of
    bfloat16 (the output advanced by frames in bfloat16 units), widened to
    complex64, against the plain version, one store a value."""
    monkeypatch.setenv("QUPS_DAS_ACC16", "1")
    x, pi, pr, pv, nv, t0 = problem("virtual", T=256, N=24, M=5, n=16)
    rng = np.random.default_rng(48)
    xc = (rng.standard_normal((256, 24, 5, 6))
          + 1j * rng.standard_normal((256, 24, 5, 6))).astype(np.complex64)
    xg = torch.as_tensor(xc).to(card)
    kw = dict(fs=4e6, tx_model="virtual", method="cubic", fmod=1e6, precision=precision,
              **KEEPS[keep])
    before = das_cuda.PREC_LAUNCHES
    got = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, **kw)
    torch.cuda.synchronize()
    assert das_cuda.PREC_LAUNCHES - before >= 2
    ref = das_cuda.das_sum_plain(xg, pi, pr, pv, nv, t0, CINV, **kw)
    assert got.dtype == ref.dtype == torch.complex64 and got.shape == ref.shape
    parts, rp = torch.view_as_real(got), torch.view_as_real(ref)
    assert torch.equal(parts, das_cuda.round_bf16_even(parts))
    off = (parts - rp).abs() - 1e-4 * float(rp.abs().max())
    assert bool((off <= 2.0 ** -7 * rp.abs()).all())
    assert float((off > 0).float().mean()) < 1e-2


@pytest.mark.cuda
def test_iq_ensemble_on_card(card):
    """The IQ ensemble path on a small plane-wave system: two frames of the
    target (the second 0.3 mm deeper) joined, hilbert, downmix, resample,
    then us.DAS (K1(b)), us.bfDAS and the c0-map DAS (K2(b)) and
    method='cubic2x' with fmod = fc, with no device=: launches counted, each
    against kernel='plain', each frame's peak on its target. A t0 that
    varies over frames is refused; the keep modes run on K1(c) and K2(c),
    and coherence_image on K1(c), each frame against kernel='plain'."""
    xdc = qt.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc,
        seq=qt.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]), c0=1540.0),
        scan=qt.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 32),
                              z=np.linspace(16e-3, 24e-3, 32)), fs=12e6)
    targets = [np.array([0.0, 0.0, 20e-3]), np.array([0.0, 0.0, 20.3e-3])]
    pad = np.array([[0.0, 0.0], [0.0, 0.0], [14e-3, 26e-3]])  # two silent bounds: one window
    chds = [us.greens(qt.Scatterers(pos=np.concatenate([t[:, None], pad], 1),
                                    amp=np.array([1.0, 0.0, 0.0]), c0=1540.0))
            for t in targets]
    iq = chds[0].join(chds[1:]).hilbert().downmix(us.fc).resample(us.fs / 2)
    assert iq.data.is_cuda and iq.data.shape[3] == 2 and iq.is_complex
    cmap = np.full(us.scan.shape, 1540.0)
    P = us.scan.positions().reshape(3, -1)
    for data in (iq.data, iq.data.real.contiguous()):
        chd = iq.replace(data=data)
        calls = {"DAS": (lambda **k: us.DAS(chd, fmod=us.fc, **k), "LAUNCHES"),
                 "bfDAS": (lambda **k: us.bfDAS(chd, fmod=us.fc, **k), "LUT_LAUNCHES"),
                 "DAS c0 map": (lambda **k: us.DAS(chd, fmod=us.fc, c0=cmap, **k),
                                "LUT_LAUNCHES"),
                 "DAS cubic2x": (lambda **k: us.DAS(chd, fmod=us.fc, method="cubic2x", **k),
                                 "LAUNCHES")}
        for name, (fn, counter) in calls.items():
            before = getattr(das_cuda, counter)
            b = fn()
            torch.cuda.synchronize()
            assert getattr(das_cuda, counter) == before + 1, name
            ref = fn(kernel="plain")
            assert b.is_cuda and b.dtype == torch.complex64
            assert b.shape == ref.shape == tuple(us.scan.shape) + (1, 1, 2)
            assert float((b - ref).abs().max()) < 1e-4 * float(ref.abs().max()), name
            if data.is_complex():
                for f, t in enumerate(targets):
                    k = int(b[..., f].abs().reshape(-1).argmax())
                    assert np.linalg.norm(P[:, k] - t) < 1.1e-3, (name, f)
    bad = iq.replace(t0=np.zeros((1, 1, 3, 2), np.float32))
    with pytest.raises(ValueError, match="frames"):
        us.DAS(bad, fmod=us.fc)
    # keep_rx holds one complex frame's sums a launch (2 launches), keep_tx 4
    for fn, counter, launches in (
            (lambda **k: us.DAS(iq, fmod=us.fc, keep_rx=True, **k), "KEEP_LAUNCHES", 2),
            (lambda **k: us.bfDAS(iq, fmod=us.fc, keep_tx=True, **k), "LUT_KEEP_LAUNCHES", 1),
            (lambda **k: us.coherence_image(iq, fmod=us.fc, **k), "KEEP_LAUNCHES", 2)):
        before = getattr(das_cuda, counter)
        b = fn()
        torch.cuda.synchronize()
        assert getattr(das_cuda, counter) == before + launches
        ref = fn(kernel="plain")
        assert b.shape == ref.shape and b.shape[-1] == 2
        assert float((b - ref).abs().max()) < 1e-4 * float(ref.abs().max())


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
    # 300 pulses (K4(b)) on the same tables: no cap, the plain version's image
    x, *rest = adjoint_problem(V=300)
    xg = torch.as_tensor(x, device=card)
    for precision, tol in (("f32", 1e-4), ("bf16", 2e-3)):
        got = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, precision=precision, **kw)
        ref = bf_adjoint(xg, *rest, bins, precision=precision, **kw)
        assert float((got - ref).abs().max()) < tol * float(ref.abs().max()), precision


K4B = [("", 12, 300), ("", 64, 1024), ("tx", 12, 300), ("tx", 64, 1024),
       ("rx", 1024, 300), ("rx", 64, 1024), ("rx", 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("keep,N,V", K4B)
def test_k4b_matches_plain(card, keep, N, V):
    """K4(b): 300 and 1024 synthesized pulses and, with keep_rx, 1024
    receivers, against the plain version in f32 (< 1e-4) and bf16
    (< 2e-3); two launches bit-identical. keep_rx holds conj(Ahat) in one
    pass at V = 300 and by chunks at V = 1024 (rx_chunk: 256 columns in
    bf16, 128 in f32)."""
    x, *rest = adjoint_problem(T=128, N=N, M=32, V=V, I=300, seed=50)
    xg = torch.as_tensor(x, device=card)
    bins = np.array([20, 23, 24, 31, 40, 41], np.int32)
    kw = dict(fs=40e6, keep_rx=keep == "rx", keep_tx=keep == "tx")
    for precision, tol in (("f32", 1e-4), ("bf16", 2e-3)):
        chunked = keep == "rx" and fdbf_cuda.rx_chunk(N, V, precision) > 0
        assert chunked == (keep == "rx" and V == 1024), precision
        before = fdbf_cuda.LAUNCHES
        got = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, precision=precision, **kw)
        again = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, precision=precision, **kw)
        torch.cuda.synchronize()
        assert fdbf_cuda.LAUNCHES == before + 2
        ref = bf_adjoint(xg, *rest, bins, precision=precision, **kw)
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) < tol * float(ref.abs().max()), precision
        assert torch.equal(got, again), precision


@pytest.mark.cuda
@pytest.mark.parametrize("vh", [64, 128])
def test_k4b_rx_chunks_forced(card, vh, monkeypatch):
    """keep_rx by chunks where one pass would fit (V = 300, chunks of 64 or
    128 columns, the last one ragged): against the plain version and the
    one-pass launch, in both precisions; two launches bit-identical."""
    x, *rest = adjoint_problem(T=128, N=200, M=48, V=300, I=260, seed=51)
    xg = torch.as_tensor(x, device=card)
    bins = np.array([20, 24, 31, 40], np.int32)
    for precision, tol in (("f32", 1e-4), ("bf16", 2e-3)):
        kw = dict(fs=40e6, keep_rx=True, precision=precision)
        one = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(fdbf_cuda, "rx_chunk", lambda *a: vh)
            got = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, **kw)
            again = fdbf_cuda.bf_adjoint_cuda(xg, *rest, bins, **kw)
        ref = bf_adjoint(xg, *rest, bins, **kw)
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) < tol * scale, precision
        assert float((got - one).abs().max()) < 1e-5 * scale, precision
        assert torch.equal(got, again), precision


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
    with kernel='plain', and each image's peak on the target; bfDAS in
    bf16pair and i8x4 (K2(e)) against the plain version at that precision."""
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
    # K2(c): keep modes and dense weights, against kernel='plain'
    for kw in (dict(keep_rx=True), dict(keep_tx=True),
               dict(apod=np.linspace(0.5, 1.5, 16).reshape(1, 1, 1, 16, 1)),
               dict(c0=cmap, apod=us.ap_aperture_growth(f=1.0), keep_tx=True)):
        before = das_cuda.LUT_KEEP_LAUNCHES
        fn = us.DAS if "c0" in kw else us.bfDAS
        got = fn(chd, **kw)
        torch.cuda.synchronize()
        assert das_cuda.LUT_KEEP_LAUNCHES == before + 1
        ref = fn(chd, kernel="plain", **kw)
        assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max()), kw
    # K2(e): the trace precisions run, against the plain version at the same
    # precision; 'bf16' is K1's alone (the c0-map route raises, as das_lut_plan)
    tables = us.das_delay_tables(device=card)
    for precision in ("bf16pair", "i8x4"):
        before = das_cuda.LUT_PREC_LAUNCHES, das_cuda.LUT_LAUNCHES
        got = us.bfDAS(chd, precision=precision)
        torch.cuda.synchronize()
        assert (das_cuda.LUT_PREC_LAUNCHES, das_cuda.LUT_LAUNCHES) == (before[0] + 1, before[1])
        ref = das_cuda.das_lut_sum_plain(chd.data, *tables, chd.t0, fs=float(chd.fs),
                                         method="cubic", precision=precision)
        assert float((got.reshape(ref.shape) - ref).abs().max()) \
            < 1e-4 * float(ref.abs().max()), precision
        assert np.linalg.norm(P[:, int(got.abs().reshape(-1).argmax())] - target) < 1.1e-3
    with pytest.raises(ValueError, match="unknown precision 'bf16'"):
        us.DAS(rf, c0=cmap, precision="bf16")
    with pytest.raises(TypeError):
        us.bfDAS(chd, apod=qt.Fused("aperture_growth"))


@pytest.mark.cuda
@pytest.mark.parametrize("medium", ["homogeneous", "lens"])
def test_bf_eikonal_on_card(card, medium):
    """bfEikonal with no device=: the host fast-marching tables, then K2 on
    the card, against kernel='plain' (< 1e-4); the tables on the card equal
    the CPU's; the peak within 1.1 mm of the target, which is simulated
    at the lens's effective straight-ray speed through a 1300 m/s layer
    over the first 5 mm."""
    xdc = qt.TransducerArray(numel=16, pitch=0.5e-3, fc=3e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=16, c0=1540.0),
        scan=qt.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 33),
                              z=np.linspace(20e-3, 36e-3, 33)), fs=24e6)
    if medium == "lens":
        med = qt.Medium(c0=1540.0, pertreg=((lambda P: P[2] < 5e-3, {"c": 1300.0}),))
        c = 28e-3 / (5e-3 / 1300.0 + 23e-3 / 1540.0)
    else:
        med, c = qt.Medium(c0=1540.0), 1540.0
    chd = us.greens(qt.Scatterers(pos=[[0.0], [0.0], [28e-3]], c0=c))
    before = das_cuda.LUT_LAUNCHES
    b = us.bfEikonal(chd, med)
    torch.cuda.synchronize()
    assert das_cuda.LUT_LAUNCHES == before + 1 and b.is_cuda
    ref = us.bfEikonal(chd, med, kernel="plain")
    assert float((b - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    cgrd = us._eikonal_grid()
    host = us.eikonal_tables(med, cgrd, device="cpu")
    for got, ref in zip(us.eikonal_tables(med, cgrd), host):
        assert got.is_cuda and torch.equal(got.cpu(), ref)
    P = us.scan.positions().reshape(3, -1)
    k = int(b.abs().reshape(-1).argmax())
    assert np.linalg.norm(P[:, k] - np.array([0.0, 0.0, 28e-3])) < 1.1e-3


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


def k5_problem(case, S=700, N=150, M=6, z=(8e-3, 30e-3), width=15e-3, seed=46):
    """A splat problem: S scatterers over x in +-8 mm and the given depths,
    N receivers over x in +-width, M transmits; a 41-tap kernel."""
    rng = np.random.default_rng(seed)
    fs, c0, K = 30e6, 1540.0, 41
    kern = (np.hanning(K) * np.sin(2 * np.pi * 5e6 * np.arange(K) / fs)).astype(np.float32)
    if case == "complex_kernel":
        kern = kern * np.exp(1j * np.linspace(0, 2, K)).astype(np.complex64)
    ps = np.stack([rng.uniform(-8e-3, 8e-3, S), np.zeros(S), rng.uniform(*z, S)], -1)
    amp = rng.uniform(0.5, 1.5, S)
    pn = np.stack([np.linspace(-width, width, N), np.zeros(N), np.zeros(N)], -1)[:, None]
    pv = np.stack([np.linspace(-5e-3, 5e-3, M), np.zeros(M), np.zeros(M)], -1)[:, None]
    if case == "subelements":
        pn = np.concatenate([pn - [1e-4, 0, 0], pn + [1e-4, 0, 0]], axis=1)
    kw = dict(T=1200, s0=2 * z[0] / c0 - 1e-6, t0k=-K / 2 / fs, fs=fs, cinv=1 / c0,
              R0=3e-4)
    return kern, ps, amp, pn, pv, kw


def _k5_grid_checks(card, plan, en=-1):
    """K5 against splat_plain on a device plan: one launch, within 1e-4, and
    a second launch bit-identical. Returns the grid."""
    args = (plan["lo"], plan["hi"], plan["scat"], plan["pn"][en], plan["ofs_pad"],
            plan["pv"][0])
    before = greens_cuda.LAUNCHES
    got = greens_cuda.splat(*args, **plan["st"])
    torch.cuda.synchronize()
    assert greens_cuda.LAUNCHES == before + 1
    ref = greens_cuda.splat_plain(*args, **plan["st"])
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    assert torch.equal(greens_cuda.splat(*args, **plan["st"]), got)  # runs repeat bit for bit
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("case", ["real", "complex_kernel", "subelements"])
def test_k5_matches_plain(card, case, method):
    """K5's grid against splat_plain on the device plan (several receiver
    groups, a partial band), two launches bit-identical; then greens_tiled's
    traces through the device plan, K5 and the finish kernel against
    kernel='plain'."""
    from qups_tpu_torch.ops.greens_cuda import greens_tiled, plan_tiled_device

    kern, ps, amp, pn, pv, kw = k5_problem(case)
    kw = dict(kw, method=method)
    plan = plan_tiled_device(kern, ps, amp, pn, pv, device=card, **kw)
    assert plan["scat"].is_cuda and plan["lo"].is_cuda
    assert _k5_grid_checks(card, plan).shape[2] == 256
    before = (greens_cuda.LAUNCHES, greens_cuda.FINISH_LAUNCHES)
    x = greens_tiled(kern, ps, amp, pn, pv, device=card, **kw)
    assert (greens_cuda.LAUNCHES, greens_cuda.FINISH_LAUNCHES) == (
        before[0] + pn.shape[1], before[1] + 1)
    xp = greens_tiled(kern, ps, amp, pn, pv, device=card, kernel="plain", **kw)
    assert x.is_cuda and x.dtype == xp.dtype and x.shape == (1200, 150, 6)
    assert float((x - xp).abs().max()) < 1e-4 * float(xp.abs().max())


@pytest.mark.cuda
def test_k5_windows_cross_bands_and_groups(card):
    """A wide aperture (300 receivers over +-40 mm: 12 groups of 32) and
    shallow scatterers (2-10 mm), so that the groups' windows differ and a
    scatterer's rows cross several bands: K5 against splat_plain, two
    launches bit-identical, and the visits fewer than the windows of whole
    receiver blocks would make."""
    from qups_tpu_torch.ops.greens_cuda import plan_tiled_device, visits

    kern, ps, amp, pn, pv, kw = k5_problem("real", S=900, N=300, M=5, z=(2e-3, 10e-3),
                                           width=40e-3, seed=50)
    plan = plan_tiled_device(kern, ps, amp, pn, pv, method="cubic", device=card, **kw)
    lo, hi = plan["lo"], plan["hi"]
    assert lo.shape[1] > 2 and lo.shape[2] == 12
    assert bool((lo != lo[:, :, :1]).any())  # the groups' windows differ
    _k5_grid_checks(card, plan, en=0)
    whole = (hi.amax(2) - lo.amin(2)).clamp(min=0).sum() * 32 * lo.shape[2]
    assert visits(plan) < int(whole)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["real", "complex_kernel", "subelements"])
def test_device_plan_on_card_matches_numpy(card, case):
    """The plan as the card computes it against the numpy plan (the JAX
    package's): P0 and Gtime equal, row offsets within 1 (a float32 median
    at a half-integer may round the other way on the card), the same
    scatterers; and greens_tiled's traces against splat_plain and
    finish_plain run on the numpy plan, uploaded, which share nothing with
    the device plan."""
    from qups_tpu_torch.ops.greens_cuda import (GROUP, BAND, finish_plain, greens_tiled,
                                                plan_tiled, plan_tiled_device, splat_plain)

    kern, ps, amp, pn, pv, kw = k5_problem(case)
    kw = dict(kw, method="cubic")
    plan = plan_tiled_device(kern, ps, amp, pn, pv, device=card, **kw)
    npl = plan_tiled(kern, ps, amp, pn, pv, **kw)
    assert (plan["P0"], plan["st"]["Gtime"]) == (npl["P0"], npl["st"]["Gtime"])
    assert int(np.abs(plan["ofs"].cpu().numpy() - npl["ofs"]).max()) <= 1
    S = ps.shape[0]
    lex = lambda a: a[np.lexsort(a.T[::-1])]  # noqa: E731
    np.testing.assert_array_equal(lex(plan["scat"].cpu().numpy()), lex(npl["scat"][:S]))
    assert not npl["scat"][S:, 3].any()
    up = lambda a: torch.as_tensor(a, device=card)  # noqa: E731
    st = {k: v for k, v in npl["st"].items() if k != "CS"}
    M, Npad = npl["pv"].shape[2], npl["pn"].shape[2]
    win = torch.zeros((M, -(-st["Gtime"] // BAND), Npad // GROUP), dtype=torch.int32,
                      device=card)
    grid = sum(splat_plain(win, win, up(npl["scat"]), up(pnk), up(npl["ofs_pad"]), up(pvk),
                           **st) for pnk in npl["pn"] for pvk in npl["pv"])
    ref = finish_plain(grid, up(npl["kern"]), T=kw["T"], P0=npl["P0"], ofs=npl["ofs"])
    x = greens_tiled(kern, ps, amp, pn, pv, device=card, **kw)
    assert x.shape == ref.shape and x.dtype == ref.dtype
    assert float((x - ref).abs().max()) < 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [35, 80])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_finish_kernel_matches_plain(card, cplx, K):
    """The finish kernel against finish_plain on a random grid: shifts that
    take rows off both ends of the grid, receivers and transmits that leave
    partial tiles. With K = 35 taps the plain version multiplies and adds
    directly in the kernel's order: bit for bit; K = 80 goes through its FFT
    (1e-4)."""
    g = torch.Generator(device=card).manual_seed(51)
    M, Gtime, Npad, N, T = 13, 300, 128, 100, 290
    grid = torch.randn((M, Gtime, Npad), generator=g, device=card)
    kern = torch.randn((K,), generator=g, device=card)
    if cplx:
        kern = torch.complex(kern, torch.randn((K,), generator=g, device=card))
    ofs = torch.randint(0, 60, (N,), generator=g, device=card)
    before = greens_cuda.FINISH_LAUNCHES
    got = greens_cuda.finish(grid, kern, T=T, P0=30, ofs=ofs)
    torch.cuda.synchronize()
    assert greens_cuda.FINISH_LAUNCHES == before + 1
    ref = greens_cuda.finish_plain(grid, kern, T=T, P0=30, ofs=ofs)
    assert got.shape == ref.shape == (T, N, M) and got.dtype == ref.dtype
    if K <= 64:
        assert torch.equal(got, ref)
    else:
        assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_layout_and_k1_at_65536_receivers(card):
    """A 256 x 256 matrix array's 65536 receivers, more than a grid
    dimension's 65535 blocks: the layout kernel bit for bit against its plain
    version for every sampler, and DAS on such traces runs K1 and matches
    the plain version."""
    N, T, M = 65536, 6, 2
    rng = np.random.default_rng(52)
    x = torch.as_tensor(rng.standard_normal((T, N, M)).astype(np.float32), device=card)
    for method in METHODS:
        got = das_cuda.trace_layout(x, method)
        assert torch.equal(got, das_cuda.trace_layout_plain(x, method)), method
    gx, gy = np.meshgrid(np.linspace(-5, 5, 256), np.linspace(-5, 5, 256))
    pr = np.stack([gx.ravel(), gy.ravel(), np.zeros(N)], -1).astype(np.float32)
    pi = np.stack([rng.uniform(-3, 3, 16), rng.uniform(-3, 3, 16), rng.uniform(1, 2, 16)],
                  -1).astype(np.float32)
    pv, nv = np.zeros((M, 3), np.float32), np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
    kw = dict(fs=1.0, tx_model="plane", method="linear")
    before = das_cuda.LAUNCHES
    b = das_cuda.das_sum(x, pi, pr, pv, nv, np.zeros(M, np.float32), 1.0, **kw)
    torch.cuda.synchronize()
    assert das_cuda.LAUNCHES == before + 1
    ref = das_cuda.das_sum_plain(x, pi, pr, pv, nv, np.zeros(M, np.float32), 1.0, **kw)
    assert float((b - ref).abs().max()) < 1e-4 * float(ref.abs().max())


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


# ------------------------------------------ modules without a TPU kernel
def _close(got, ref, tol):
    """max|got - ref| / max|ref| for a card result and a CPU one, printed
    (``-s``) and held under ``tol``."""
    assert got.is_cuda and not ref.is_cuda and got.shape == ref.shape
    r = float((got.cpu() - ref).abs().max() / ref.abs().max())
    print(f"card vs cpu {r:.3e} (limit {tol:.0e})")
    assert r < tol
    return r


def _hadamard(n):
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(gamma=0.0), dict(), dict(method="adjoint"),
                                dict(method="pinv")], ids=["tik0", "tik", "adjoint", "pinv"])
def test_refocus_on_card(card, kw):
    """us.refocus with no device= decodes on the card, equal to the CPU
    decode within 1e-4 x max, with 2 frames; the operator cache keys by
    device."""
    from qups_tpu_torch import system as tsystem

    xdc = qt.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=16),
                             scan=qt.ScanCartesian(x=[0.0], z=[30e-3]), fs=24e6)
    fsa = us.greens(qt.Scatterers(pos=[[0.0], [0.0], [30e-3]], c0=1540.0), device="cpu")
    enc_seq = qt.Sequence(type="FSA", numpulse=16, apd=_hadamard(16), del_=np.zeros((16, 16)))
    enc = us.focusTx(fsa, enc_seq, device="cpu")
    enc = enc.replace(data=torch.stack([enc.data, 0.5 * enc.data], -1))
    tsystem._REFOCUS_OP_CACHE.clear()
    dec = us.refocus(enc, enc_seq, **kw)
    ref = us.refocus(enc, enc_seq, device="cpu", **kw)
    assert {k[-1] for k in tsystem._REFOCUS_OP_CACHE} == {"cuda", "cpu"}
    _close(dec.data, ref.data, 1e-4)
    if kw == dict(gamma=0.0):  # the decode recovers the FSA echoes
        x0 = float(fsa.data.abs().max())
        assert float((dec.data[..., 0].cpu() - fsa.data).abs().max()) < 0.05 * x0
    tsystem._REFOCUS_OP_CACHE.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 24, 16), (64, 16, 24)])
def test_spectral_norm_on_card(card, shape):
    """The spectral norm on the card equals the CPU's within 1e-5 relative,
    a rank-1 bin too, and a Hadamard encoding's norm, sqrt(M), to float32
    rounding."""
    from qups_tpu_torch.ops.fdbf import spectral_norm

    rng = np.random.default_rng(60)
    H = torch.complex(torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32),
                      torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32))
    H[0] = torch.ones(shape[1:], dtype=torch.complex64)  # rank 1
    got, ref = spectral_norm(H.to(card)), spectral_norm(H)
    assert float(((got.cpu() - ref) / ref).abs().max()) < 1e-5
    had = torch.as_tensor(_hadamard(32), dtype=torch.complex64)[None].repeat(8, 1, 1)
    assert float((spectral_norm(had.to(card)) - 32 ** 0.5).abs().max()) < 1e-5 * 32 ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("keep_tx", [False, True])
def test_bf_migration_on_card(card, keep_tx):
    """bfMigration with no device= on the card, 2 frames: equal to the CPU
    within 1e-4 x max, each target's peak within 1.1 mm."""
    xdc = qt.TransducerArray(numel=32, pitch=0.3e-3, fc=3e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.SequenceRadial(type="PW", angles=[-5.0, 0.0, 5.0], c0=1540.0),
        scan=qt.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 41),
                              z=np.linspace(25e-3, 35e-3, 41)), fs=24e6)
    target = np.array([1e-3, 0.0, 30e-3])
    chd = us.greens(qt.Scatterers(pos=target[:, None], c0=1540.0), device="cpu")
    chd = chd.replace(data=torch.stack([chd.data, -chd.data], -1))
    b, bscan = us.bfMigration(chd, keep_tx=keep_tx)
    ref, _ = us.bfMigration(chd, keep_tx=keep_tx, device="cpu")
    _close(b, ref, 1e-4)
    P = us.scan.positions().reshape(3, -1)
    k = int(b[..., 0].abs().sum(-1).reshape(-1).argmax())
    assert np.linalg.norm(P[:, k] - target) < 1.1e-3


@pytest.mark.cuda
def test_ray_paths_on_card(card):
    """ray_paths_device with no device= on the card: the CPU's weights
    within 1e-5 x the largest (the deposits are atomic on the card), each
    ray's total its length."""
    from qups_tpu_torch.ops.rays import ray_paths_device, wbilerp_dense

    xg, zg = np.linspace(-10e-3, 10e-3, 64), np.linspace(0.0, 20e-3, 80)
    rng = np.random.default_rng(61)
    pa = np.stack([rng.uniform(-10e-3, 10e-3, 500), rng.uniform(0, 20e-3, 500)])
    pb = np.stack([rng.uniform(-10e-3, 10e-3, 500), rng.uniform(0, 20e-3, 500)])
    W = ray_paths_device(xg, zg, pa, pb)
    _close(W, ray_paths_device(xg, zg, pa, pb, device="cpu"), 1e-5)
    assert torch.allclose(W.sum((0, 1)).double().cpu(),
                          torch.as_tensor(np.hypot(*(pb - pa))), atol=1e-6)
    one = wbilerp_dense(xg, zg, pa[:, 0], pb[:, 0])
    assert one.is_cuda and torch.allclose(one, W[:, :, 0], atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_kspace_sims_on_card(card, nd):
    """The k-space steppers with no device= on the card, absorbing and
    nonlinear, with field snapshots and a batch of two sources: equal to
    the CPU run within 2e-4 x max (cuFFT and the CPU's FFTs round
    differently; the scheme gathers float32 rounding over the steps)."""
    from qups_tpu_torch.sim import fdtd

    n = {1: 256, 2: 64, 3: 24}[nd]
    shape = (n,) * nd
    rng = np.random.default_rng(62)
    c = 1500.0 + rng.uniform(0, 60, shape)
    rho = 1000.0 + rng.uniform(0, 200, shape)
    h = 0.2e-3
    dt = 0.3 * h / c.max()
    steps = 60
    t = np.arange(steps) * dt
    s = (np.exp(-((t - 0.8e-6) * 4e6) ** 2) * np.sin(2 * np.pi * 2e6 * t)).astype(np.float32)
    sig = np.stack([s, -0.5 * s], 1)[:, :, None]  # (steps, B, Q)
    kw = dict(steps=steps, dt=dt, dx=h, c_ref=float(c.max()), record_rows=(n // 2, n - 6),
              alpha0=np.full(shape, 0.75), alpha_power=1.3, bona=np.full(shape, 8.0),
              field_stride=10)
    src = {1: [np.array([6])], 2: [[6], [n // 2]], 3: [np.array([[6], [n // 2], [n // 2]])]}[nd]
    sim = {1: fdtd.kspace_sim_1d, 2: fdtd.kspace_sim_2d, 3: fdtd.kspace_sim_3d}[nd]
    rec, fld = sim(c, rho, *src, sig, **kw)
    rref, fref = sim(c, rho, *src, sig, device="cpu", **kw)
    _close(rec, rref, 2e-4)
    _close(fld, fref, 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(el_proj="karray", record="field", field_stride=10),
                                dict(bg_subtract=True)], ids=["nearest", "karray-field", "bg"])
def test_kspace_first_order_on_card(card, kw):
    """kspaceFirstOrder with no device= on the card (3 transmits in one
    batch): traces (and fields) on the card, equal to the CPU run within
    1e-4 x max (1e-3 of the full traces' peak with background
    subtraction)."""
    c0, fc = 1500.0, 2e6
    lam = c0 / fc
    xdc = qt.TransducerArray(numel=8, pitch=lam / 2, fc=fc)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.SequenceRadial(type="PW", angles=[-5.0, 0.0, 5.0], c0=c0),
        scan=qt.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8), z=np.linspace(1e-3, 6e-3, 8)),
        fs=4 * fc)
    blob = lambda P: np.hypot(P[0], P[2] - 4e-3) < lam / 4  # noqa: E731
    med = qt.Medium(c0=c0, rho0=1000.0, pertreg=((blob, {"rho": 2200.0}),))
    cgrd = qt.ScanCartesian(x=np.arange(-3e-3, 3e-3, lam / 6), y=[0.0],
                            z=np.arange(-0.5e-3, 6.5e-3, lam / 6))
    got = us.kspaceFirstOrder(med, cgrd, tmax=8e-6, **kw)
    ref = us.kspaceFirstOrder(med, cgrd, tmax=8e-6, device="cpu", **kw)
    if "record" in kw:
        (got, fgot), (ref, fref) = got, ref
        _close(fgot, fref, 1e-4)
    if kw.get("bg_subtract"):
        full = us.kspaceFirstOrder(med, cgrd, tmax=8e-6, device="cpu")
        r = float((got.data.cpu() - ref.data).abs().max() / full.data.abs().max())
        assert got.data.is_cuda and r < 1e-3, r
    else:
        _close(got.data, ref.data, 1e-4)
    np.testing.assert_array_equal(got.t0_host, ref.t0_host)


def _vantage_file(path, F=2, seed=12):
    """A small Vantage plane-wave workspace (.mat) of a point target: 32
    elements through a permuted ConnectorES, 3 plane waves, F frames (0.3 mm
    deeper each), int16 rows in 128-sample blocks, the Vantage delays.
    Returns the acquisition's start on the Vantage clock and the targets."""
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    c0, fc, numel = 1540.0, 5.208e6, 32
    Trans = dict(name="L-test", units="mm", frequency=5.208, numelements=numel,
                 elementWidth=0.27, elementLength=5.0, spacingMm=0.3,
                 Bandwidth=np.array([3.5, 7.0]), type=0, ElementPos=np.zeros((numel, 5)),
                 ConnectorES=rng.permutation(numel) + 1)
    xdc = qt.interop.transducer_from_verasonics(Trans, c0)
    angs = np.array([-8.0, 0.0, 8.0])
    seq = qt.SequenceRadial(type="PW", angles=angs, c0=c0)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=qt.ScanCartesian(
        x=np.linspace(-4e-3, 4e-3, 48), z=np.linspace(12e-3, 20e-3, 48)), fs=4 * fc)
    targets = [np.array([0.5e-3, 0.0, 15e-3 + 0.3e-3 * f]) for f in range(F)]
    silent = np.array([[0.0, 0.0], [0.0, 0.0], [8e-3, 22e-3]])
    chds = [us.greens(qt.Scatterers(pos=np.concatenate([t.reshape(3, 1), silent], 1),
                                    amp=np.array([1.0, 0.0, 0.0]), c0=c0), device="cpu")
            for t in targets]
    x = np.stack([c.data.real.numpy() for c in chds], -1)
    T = -(-x.shape[0] // 128) * 128
    q16 = np.zeros((T,) + x.shape[1:], np.int16)
    q16[:x.shape[0]] = np.round(x / np.abs(x).max() * 8000).astype(np.int16)
    M = len(angs)
    rcv = np.zeros((T * M, numel, F), np.int16)
    for a in range(M):
        rcv[a * T:(a + 1) * T, Trans["ConnectorES"] - 1] = q16[:, :, a]
    tau = seq.delays(xdc)
    start = chds[0].t0_host[0] + tau.max(axis=0)

    def records(rows):
        a = np.zeros((len(rows),), dtype=[(n, "O") for n in rows[0]])
        for i, r in enumerate(rows):
            a[i] = tuple(r.values())
        return a

    Receive = records([dict(bufnum=1, framenum=f + 1, acqNum=a + 1, startSample=a * T + 1,
                            endSample=(a + 1) * T, decimSampleRate=4 * 5.208,
                            demodFrequency=5.208, sampleMode="NS200BW", Apod=np.ones(numel))
                       for f in range(F) for a in range(M)])
    TX = records([dict(Apod=np.ones(numel), Steer=np.array([np.radians(a), 0.0]), focus=0.0,
                       Origin=np.zeros(3), Delay=(tau[:, m].max() - tau[:, m]) * fc)
                  for m, a in enumerate(angs)])
    ws = dict(Trans=Trans, Receive=Receive, TX=TX, RcvData=np.empty((1,), object),
              Resource=dict(Parameters=dict(speedOfSound=c0)))
    ws["RcvData"][0] = rcv
    savemat(path, ws, long_field_names=True)
    return us.scan, start, targets


@pytest.mark.cuda
def test_vantage_workspace_on_card(card, tmp_path):
    """A Vantage workspace read by interop.load_verasonics (traces on the
    host), beamformed with no device= on the card: RF frames on K1(b), and
    IQ after hilbert and downmix on the card with fmod; each against the
    same call on device="cpu" within 1e-4 x max, each frame's peak on its
    target."""
    p = tmp_path / "ws.mat"
    scan, start, targets = _vantage_file(p)
    out = qt.interop.load_verasonics(p)
    chd = out["chd"][0]
    assert chd.data.device.type == "cpu"
    chd = chd.replace(t0=(start + out["t0"]).reshape(1, 1, -1))
    us = qt.UltrasoundSystem(tx=out["xdc"], rx=out["xdc"], seq=out["seq"], scan=scan,
                             fs=chd.fs)
    fc = out["fmod"][0]
    before = das_cuda.LAUNCHES
    b = us.DAS(chd)
    g = chd.replace(data=chd.data.to(card))
    iq = g.hilbert().downmix(fc)
    bi = us.DAS(iq, fmod=fc)
    torch.cuda.synchronize()
    assert das_cuda.LAUNCHES == before + 2 and b.is_cuda and bi.is_cuda
    ref = us.DAS(chd, device="cpu")
    refi = us.DAS(chd.hilbert().downmix(fc), fmod=fc, device="cpu")
    P = scan.positions().reshape(3, -1)
    for got, r in ((b, ref), (bi, refi)):
        assert float((got.cpu() - r).abs().max()) < 1e-4 * float(r.abs().max())
        for f, tg in enumerate(targets):
            k = int(got[..., f].abs().reshape(-1).argmax())
            assert np.linalg.norm(P[:, k] - tg) < 1.1e-3


@pytest.mark.cuda
def test_io_round_trips_on_card(card, tmp_path):
    """save_chd / load_chd(device=) and save_checkpoint /
    load_checkpoint(like=) with tensors on the card: back on the card, bit
    for bit; without a template, on the host."""
    x = torch.randn(64, 8, 3, 2, dtype=torch.complex64, device=card)
    chd = qt.ChannelData(data=x, fs=20e6, t0=np.array([1e-6, 2e-6, 3e-6]))
    qt.io.save_chd(str(tmp_path / "c.npz"), chd)
    back = qt.io.load_chd(str(tmp_path / "c.npz"), device=card)
    assert back.data.is_cuda and torch.equal(back.data, x)
    assert qt.io.load_chd(str(tmp_path / "c.npz")).data.device.type == "cpu"
    tree = {"img": torch.randn(16, 16, device=card), "iq": x, "fs": np.float64(20e6)}
    p = str(tmp_path / "ck.pt")
    qt.io.save_checkpoint(p, tree)
    got = qt.io.load_checkpoint(p, like={"img": tree["img"], "iq": x})
    assert got["img"].is_cuda and got["iq"].is_cuda
    assert torch.equal(got["img"], tree["img"]) and torch.equal(got["iq"], x)
    host = qt.io.load_checkpoint(p)
    assert host["img"].device.type == "cpu" and isinstance(host["fs"], np.float64)


@pytest.mark.cuda
def test_trace_records_the_kernel(card, tmp_path):
    """utils.trace on the card: the Chrome trace holds K1(b)'s
    das_frames_kernel launched under annotate('das'); Timer with a CUDA
    tensor as sync waits for it."""
    import json

    xdc = qt.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=16),
                             scan=qt.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 32),
                                                   z=np.linspace(10e-3, 20e-3, 32)))
    x = torch.randn(512, 16, 16, 2, device=card)
    chd = qt.ChannelData(data=x, fs=12e6, t0=0.0)
    us.DAS(chd)  # built and warm
    with qt.utils.trace(str(tmp_path)):
        with qt.utils.annotate("das"):
            us.DAS(chd)
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    span = [(e["ts"], e["ts"] + e["dur"]) for e in ev
            if e.get("name") == "das" and e.get("cat") == "user_annotation"]
    gspan = [(e["ts"], e["ts"] + e["dur"]) for e in ev
             if e.get("name") == "das" and e.get("cat") == "gpu_user_annotation"]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kern = [e for e in ev if e.get("cat") == "kernel" and "das_frames_kernel" in e["name"]]
    assert span and kern
    inside = lambda t, sp: any(a <= t <= b for a, b in sp)  # noqa: E731
    assert any(inside(launch.get(e["args"].get("correlation"), -1.0), span)
               or inside(e["ts"], gspan) for e in kern)
    tm = qt.utils.Timer()
    with tm("das", sync=x):
        x.mul_(1.0)
    assert tm.times["das"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(precision="bf16pair"), dict(keep_rx=True),
                                dict(post="cohfac"), dict(post="slsc")])
def test_das_sharded_pallas_on_card(card, kw):
    """das_sharded_pallas on four shards of one card ([cuda:0] * 4, a (2, 2)
    (rx, tx) mesh): K1 once per shard (K1(e), K1(c) with kw), then the
    reductions on the card, against das_sum without a mesh (the
    coherence reductions against ops/coherence.py on its keep_rx image)."""
    from qups_tpu_torch.ops.coherence import cohfac, slsc
    from qups_tpu_torch.parallel import das_sharded_pallas, make_mesh

    kw = dict(kw)
    x, pi, pr, pv, nv, t0 = problem("plane", N=30)  # 30 rx: a padded rx shard
    xg = torch.as_tensor(x, device=card)
    mesh = make_mesh([torch.device("cuda", 0)] * 4, axes=("rx", "tx"), shape=(2, 2))
    counts = {k: getattr(das_cuda, k) for k in ("LAUNCHES", "PREC_LAUNCHES", "KEEP_LAUNCHES")}
    got = das_sharded_pallas(mesh, xg, pi, pr, pv, nv, t0, CINV, fs=4e6, tx_model="plane",
                             method="cubic", im_shape=(64, 64, 1), **kw)
    launched = {k: getattr(das_cuda, k) - v for k, v in counts.items()}
    assert sum(launched.values()) == 4, launched
    post = kw.pop("post", None)
    keep = dict(keep_rx=True) if post else {}
    ref = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, fs=4e6, tx_model="plane",
                           method="cubic", **keep, **kw)
    if post:
        brx = ref[:, :, 0]
        ref = cohfac(brx, axis=1).abs() if post == "cohfac" else slsc(brx, axis=1)
    assert got.is_cuda and got.shape == ref.shape
    tol = 1e-3 if post == "slsc" else 1e-4
    assert float((got - ref).abs().max()) < tol * float(ref.abs().max())


@pytest.mark.cuda
def test_sharded_k3_k4_on_card(card):
    """greens_freq_sharded (K3 per (scatterer, rx) block) and
    bf_adjoint_sharded (K4 per pixel block, the spectra copied) on [cuda:0]
    * 4 against their unsharded calls; K4's pixel blocks bit for bit."""
    from qups_tpu_torch.ops.greens_freq import greens_freq
    from qups_tpu_torch.parallel import bf_adjoint_sharded, greens_freq_sharded, make_mesh

    mesh = make_mesh([torch.device("cuda", 0)] * 4, axes=("rx", "tx"), shape=(2, 2))
    rng = np.random.default_rng(12)
    S, N, M = 301, 33, 17
    ps = np.stack([rng.uniform(-5e-3, 5e-3, S), np.zeros(S), rng.uniform(15e-3, 35e-3, S)],
                  -1).astype(np.float32)
    amp = rng.standard_normal(S).astype(np.float32)
    pn = np.stack([np.linspace(-6e-3, 6e-3, N), np.zeros(N), np.zeros(N)], -1)[:, None]
    pv = pn[::2].copy()
    kern = (np.hanning(31) * np.sin(2 * np.pi * np.arange(31) / 6)).astype(np.float32)
    kw = dict(T=1200, s0=1.5e-5, t0k=-1e-6, fs=25e6, cinv=1 / 1540.0, R0=1e-3)
    k3 = greens_freq_cuda.LAUNCHES
    got = greens_freq_sharded(mesh, kern, ps, amp, pn, pv, **kw)
    assert greens_freq_cuda.LAUNCHES - k3 == 4
    ref = greens_freq(kern, ps, amp, pn, pv, device=card, **kw)
    assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    T, N, V, I = 512, 32, 16, 1000
    x = torch.as_tensor(rng.standard_normal((T, N, V)).astype(np.float32), device=card)
    tau_rx = rng.uniform(0, 4e-6, (I, N)).astype(np.float32)
    tau_tx = rng.uniform(0, 4e-6, (I, 8)).astype(np.float32)
    args = (x, tau_rx, tau_tx, rng.uniform(0, 3e-7, (8, V)).astype(np.float32),
            rng.standard_normal((8, V)).astype(np.float32), np.zeros(V, np.float32),
            np.zeros(V, np.float32), np.arange(20, 60))
    for precision in ("bf16", "f32"):
        k4 = fdbf_cuda.LAUNCHES
        got = bf_adjoint_sharded(mesh, *args, fs=20e6, precision=precision)
        assert fdbf_cuda.LAUNCHES - k4 == 4
        assert torch.equal(got, fdbf_cuda.bf_adjoint_cuda(*args, fs=20e6, precision=precision))


@pytest.mark.cuda
def test_bench_entries_on_card(card, monkeypatch, capsys):
    """The benchmark entry points on the card at their small sizes: the
    headline (QUPS_BENCH_SIZE=small) through K1, its check the image's
    sum(|.|); every sweep at QUPS_BENCH_TINY=1 without an error line, with
    K1, K1(c), K2, K3, K4 and K5 each launched."""
    import json

    from qups_tpu_torch import bench, benches

    for k in ("QUPS_BENCH_MESH", "QUPS_BENCH_PRECISION", "QUPS_BENCH_METHOD"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("QUPS_BENCH_SIZE", "small")
    monkeypatch.setenv("QUPS_BENCH_TINY", "1")
    before = das_cuda.LAUNCHES
    bench.main([])
    (rec,) = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert das_cuda.LAUNCHES - before == 6  # cubic and linear, 3 calls each
    assert rec["detail"]["device"] == torch.cuda.get_device_name(0)
    x, pi, pr, pv, nv, t0 = bench.das_problem(**bench.CONFIGS["small"])
    img = das_cuda.das_sum(torch.as_tensor(x, device=card), pi, pr, pv, nv, t0, bench.CINV,
                           fs=bench.FS, tx_model="plane", method="cubic")
    assert rec["detail"]["check"] == float(torch.sum(torch.abs(img)))
    counts = (lambda: (das_cuda.LAUNCHES, das_cuda.KEEP_LAUNCHES, das_cuda.LUT_LAUNCHES,
                       greens_freq_cuda.LAUNCHES, fdbf_cuda.LAUNCHES, greens_cuda.LAUNCHES))
    before = counts()
    assert benches.main(["all"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert {r["bench"] for r in lines} == set(benches.BENCHES)
    assert not any("error" in r for r in lines)
    assert all(a > b for a, b in zip(counts(), before)), (counts(), before)


@pytest.mark.cuda
def test_kernel_entry_points_on_card(card):
    """The JAX-named kernel-level entry points with no device=: numpy
    inputs go to the card, each launches its kernel once and equals the
    method that makes the same launch bit for bit (das_tiled / das_sum,
    das_lut_tiled and das_lut_plan / das_lut_sum, bf_adjoint_tiled /
    bf_adjoint_cuda, freq_gemm_cuda / freq_gemm on the prologue); the shards
    of prep_sharded and prep_lut_sharded (2 x 2, 30 receivers: a padded
    shard) summed within 1e-4 of the single call."""
    from qups_tpu_torch import ops
    from qups_tpu_torch.ops.das import delay_tables

    x, pi, pr, pv, nv, t0 = problem("plane", N=30)
    xg = torch.as_tensor(x, device=card)
    kw = dict(fs=4e6, method="cubic")
    before = das_cuda.LAUNCHES
    got = ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, tx_model="plane", **kw)
    assert got.is_cuda and das_cuda.LAUNCHES - before == 1
    ref = das_cuda.das_sum(xg, pi, pr, pv, nv, t0, CINV, tx_model="plane", **kw)
    assert torch.equal(got, ref)
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device=card)
    before = das_cuda.LUT_LAUNCHES
    lut = ops.das_lut_tiled(x, tau_rx, tau_tx, t0, **kw)
    plan = ops.das_lut_plan(tau_rx.cpu().numpy(), tau_tx.cpu().numpy(), t0, T=x.shape[0],
                            N=30, M=x.shape[2], **kw)
    assert torch.equal(plan(xg), lut) and das_cuda.LUT_LAUNCHES - before == 2
    assert torch.equal(lut, das_cuda.das_lut_sum(xg, tau_rx, tau_tx, t0, **kw))
    a, st = ops.prep_sharded(pi, pr, pv, nv, t0, CINV, fs=4e6, T=x.shape[0], tx_model="plane",
                             im_shape=(64, 64, 1), nrx=2, ntx=2, method="cubic")
    Nsh, Msh = st["Nsh"], st["Msh"]
    assert (Nsh, Msh) == (16, 4) and a["pr"].is_cuda
    xp = torch.zeros((x.shape[0], 2 * Nsh, 2 * Msh), device=card)
    xp[:, :30] = xg
    img = sum(das_cuda.das_sum(xp[:, r * Nsh:(r + 1) * Nsh, t * Msh:(t + 1) * Msh], a["pi"],
                               a["pr"][r], a["pv"][t], a["nv"][t], a["t0"][t], st["cinv"],
                               tx_model="plane", **kw) for r in range(2) for t in range(2))
    assert float((img - ref).abs().max()) < 1e-4 * float(ref.abs().max())
    a, st = ops.prep_lut_sharded(tau_rx, tau_tx, t0, fs=4e6, T=x.shape[0],
                                 im_shape=(64, 64, 1), nrx=2, ntx=2, method="cubic")
    img = sum(das_cuda.das_lut_sum(xp[:, r * Nsh:(r + 1) * Nsh, t * Msh:(t + 1) * Msh],
                                   a["taur"][r], a["taut"][t], a["t0"][t], **kw)
              for r in range(2) for t in range(2))
    assert float((img - lut).abs().max()) < 1e-4 * float(lut.abs().max())
    rng = np.random.default_rng(13)
    args = (rng.standard_normal((256, 30, 8)).astype(np.float32), tau_rx, tau_tx,
            rng.uniform(0, 1e-7, (8, 8)).astype(np.float32), np.ones((8, 8), np.float32),
            np.zeros(8, np.float32), np.zeros(8, np.float32), np.arange(20, 60))
    before = fdbf_cuda.LAUNCHES
    b = ops.bf_adjoint_tiled(*args, fs=20e6, BI=16)
    assert b.is_cuda and fdbf_cuda.LAUNCHES - before == 1
    assert torch.equal(b, fdbf_cuda.bf_adjoint_cuda(torch.as_tensor(args[0], device=card),
                                                    *args[1:], fs=20e6))
    ps = np.stack([rng.uniform(-5e-3, 5e-3, 301), np.zeros(301),
                   rng.uniform(15e-3, 35e-3, 301)], -1).astype(np.float32)
    amp = rng.standard_normal(301).astype(np.float32)
    for precision in ("highest", "bf16"):
        G = ops.freq_gemm_cuda(0.05, ps, amp, pr, pv, L=512, k0=10, F=40, R0=1e-3, fsr=1.0,
                               precision=precision)
        q1, w1, q2, w2 = prologue(0.05, ps, amp, pr[:, None], pv[:, None], R0=1e-3, fsr=1.0,
                                  device=card)
        assert torch.equal(G, greens_freq_cuda.freq_gemm(q1, w1, q2, w2, k0=10, F=40,
                                                         bf16=precision == "bf16"))
    S = ops.simus_spectrum_cuda(ps, amp, pr, np.zeros(30), pr[:8], np.zeros(8),
                                [2e-4, 2e-4], k0=10, F=40, T=512, fs=20e6, c0=1540.0)
    assert S.is_cuda and S.shape == (40, 30, 8) and bool(torch.isfinite(S).all())
