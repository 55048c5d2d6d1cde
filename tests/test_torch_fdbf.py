"""The port's frequency-domain beamforming (qups_tpu_torch.ops.fdbf) against
qups_tpu: spectral_level, select_fbins, geom_delays, focus_tx_freq, and the
adjoint beamformer bf_adjoint (the plain version of kernel K4) against the
XLA engine qups_tpu.ops.fdbf.bf_adjoint and against the Pallas engine
bf_adjoint_tiled in interpret mode, for every keep mode, a ragged and an
empty bin set; then UltrasoundSystem.bfAdjoint against the JAX system. K4
itself is tested on the card in test_torch_cuda.py.

Tolerances, max|port - JAX| < tol * max|JAX|: 1e-4 against the Pallas
engine, which builds its phasors as 2 pi frac(f_k tau) as the port does;
2e-3 against the XLA engine, whose direct cexp phases differ from that by
up to ~3e-4 rad (fdbf_pallas.py:27-29)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
from qups_tpu.ops import fdbf as jfdbf  # noqa: E402
from qups_tpu.ops.fdbf_pallas import bf_adjoint_tiled  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import fdbf, fdbf_cuda  # noqa: E402
from qups_tpu_torch import system as tsystem  # noqa: E402

FS = 40e6
TARGET = np.array([0.0, 0.0, 20e-3])


def close(got, ref, tol):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < tol, err


def adjoint_problem(T=128, N=8, M=6, V=9, I=40, seed=60):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, V)).astype(np.float32)
    tau_rx = rng.uniform(0, 2e-6, (I, N)).astype(np.float32)
    tau_tx = rng.uniform(0, 2e-6, (I, M)).astype(np.float32)
    del_tx = rng.uniform(0, 3e-7, (M, V)).astype(np.float32)
    apod = rng.standard_normal((M, V)).astype(np.float32)
    t0 = rng.uniform(0, 1e-6, (V,)).astype(np.float32)
    t0o = rng.uniform(0, 1e-7, (V,)).astype(np.float32)
    return x, (tau_rx, tau_tx, del_tx, apod, t0, t0o)


BINS = {"uniform": np.arange(5, 17), "ragged": np.array([5, 9, 10, 11, 17]),
        "padded": np.array([5, 6, 7, -1, -1])}
KEEP = {"sum": {}, "rx": {"keep_rx": True}, "tx": {"keep_tx": True}}


def test_spectral_level_and_bins_match_reference():
    x, _ = adjoint_problem()
    close(fdbf.spectral_level(torch.as_tensor(x)), jfdbf.spectral_level(x), 1e-5)
    for thr in (-6.0, -20.0):
        assert np.array_equal(fdbf.select_fbins(torch.as_tensor(x), FS, thr, max_bins=20),
                              jfdbf.select_fbins(x, FS, thr, max_bins=20))


def test_geom_delays_match_reference():
    rng = np.random.default_rng(61)
    pi = rng.uniform(-0.02, 0.02, (50, 3)).astype(np.float32)
    pos = rng.uniform(-0.02, 0.02, (7, 3)).astype(np.float32)
    close(fdbf.geom_delays(pi, pos, np.float32(1 / 1540.0), "cpu"),
          jfdbf.geom_delays(pi, pos, np.float32(1 / 1540.0)), 1e-6)


@pytest.mark.parametrize("cplx", [False, True])
def test_focus_tx_freq_matches_reference(cplx):
    rng = np.random.default_rng(62)
    x = rng.standard_normal((96, 5, 6, 2)).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    t2 = rng.uniform(-1e-6, 1e-6, (6, 3))
    w = rng.uniform(size=(6, 3))
    close(fdbf.focus_tx_freq(torch.as_tensor(x), t2, w, fs=FS),
          jfdbf.focus_tx_freq(x, t2, w, fs=FS), 1e-4)


@pytest.mark.parametrize("bins", sorted(BINS))
@pytest.mark.parametrize("keep", sorted(KEEP))
def test_bf_adjoint_matches_xla(keep, bins):
    x, args = adjoint_problem()
    kw = dict(fs=FS, fmod=1e6, **KEEP[keep])
    ref = jfdbf.bf_adjoint(x, *args, BINS[bins].astype(np.int32), **kw)
    close(fdbf.bf_adjoint(torch.as_tensor(x), *args, BINS[bins], **kw), ref, 2e-3)


@pytest.mark.parametrize("bins", ["uniform", "ragged"])
@pytest.mark.parametrize("keep", sorted(KEEP))
def test_bf_adjoint_matches_pallas_interpret(keep, bins, monkeypatch):
    """The plain version against the TPU kernel in interpret mode, with
    direct sin/cos phasors on both sides (QUPS_ADJ_RECUR=0 turns off the
    TPU kernel's recurrence for evenly spaced bins)."""
    monkeypatch.setenv("QUPS_ADJ_RECUR", "0")
    x, args = adjoint_problem()
    kw = dict(fs=FS, fmod=1e6, **KEEP[keep])
    ref = bf_adjoint_tiled(x, *args, BINS[bins].astype(np.int32), precision="f32",
                           BI=8, interpret=True, **kw)
    close(fdbf.bf_adjoint(torch.as_tensor(x), *args, BINS[bins], precision="f32",
                          **kw), ref, 1e-4)


def test_bf_adjoint_bf16_matches_pallas_interpret(monkeypatch):
    """precision='bf16' rounds the dots' operands as the TPU kernel does."""
    monkeypatch.setenv("QUPS_ADJ_RECUR", "0")
    x, args = adjoint_problem()
    bins = BINS["ragged"]
    ref = bf_adjoint_tiled(x, *args, bins.astype(np.int32), fs=FS, precision="bf16",
                           BI=8, interpret=True)
    got = fdbf.bf_adjoint(torch.as_tensor(x), *args, bins, fs=FS, precision="bf16")
    close(got, ref, 2e-3)
    f32 = fdbf.bf_adjoint(torch.as_tensor(x), *args, bins, fs=FS, precision="f32")
    assert float((got - f32).abs().max()) > 0  # the rounding does happen


def test_bf_adjoint_empty_bins_and_cpu_wrapper():
    x, args = adjoint_problem()
    for keep, shape in (("sum", (40,)), ("rx", (40, 8)), ("tx", (40, 9))):
        b = fdbf.bf_adjoint(torch.as_tensor(x), *args, np.zeros(0, np.int32), fs=FS,
                            **KEEP[keep])
        assert b.shape == shape and not bool(b.abs().any())
    before = fdbf_cuda.LAUNCHES
    kw = dict(fs=FS, precision="bf16")
    got = fdbf_cuda.bf_adjoint_cuda(torch.as_tensor(x), *args, BINS["ragged"], **kw)
    assert torch.equal(got, fdbf.bf_adjoint(torch.as_tensor(x), *args, BINS["ragged"], **kw))
    assert fdbf_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        fdbf.bf_adjoint(torch.as_tensor(x), *args, BINS["ragged"], fs=FS,
                        keep_rx=True, keep_tx=True)


@pytest.fixture(scope="module")
def fsa():
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=16, c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 24),
                             z=np.linspace(16e-3, 24e-3, 24)))
    chd = us.greens(q.Scatterers(pos=TARGET[:, None], c0=1540.0))
    return us, chd, from_reference(us), from_reference(chd)


@pytest.mark.parametrize("keep", sorted(KEEP))
def test_bfadjoint_system_matches_reference(fsa, keep):
    us, chd, ust, chdt = fsa
    ref = us.bfAdjoint(chd, fthresh_db=-30, **KEEP[keep])
    got = ust.bfAdjoint(chdt, fthresh_db=-30, precision="f32", device="cpu", **KEEP[keep])
    close(got, ref, 2e-3)
    if keep == "sum":
        P = ust.scan.positions().reshape(3, -1)
        assert np.linalg.norm(P[:, int(got.abs().reshape(-1).argmax())] - TARGET) < 1.1e-3


def test_bfadjoint_frames_and_table_cache(fsa):
    """Trailing frame dims run one call per frame; the device delay tables
    are built once per geometry and sound speed."""
    _, _, ust, chdt = fsa
    tsystem._ADJ_TAU_CACHE.clear()
    b1 = ust.bfAdjoint(chdt, fthresh_db=-30, device="cpu")
    assert len(tsystem._ADJ_TAU_CACHE) == 1
    x4 = torch.stack([chdt.data, 2 * chdt.data], dim=-1)
    b4 = ust.bfAdjoint(chdt.replace(data=x4), fthresh_db=-30, device="cpu")
    assert len(tsystem._ADJ_TAU_CACHE) == 1
    assert b4.shape == b1.shape + (2,)
    assert float((b4[..., 1] - 2 * b1).abs().max()) < 1e-4 * float(b1.abs().max()) * 2
    ust.bfAdjoint(chdt, fthresh_db=-30, c0=1500.0, device="cpu")
    assert len(tsystem._ADJ_TAU_CACHE) == 2
    with pytest.raises(ValueError, match="CUDA"):
        ust.bfAdjoint(chdt, kernel="cuda", device="cpu")


@pytest.mark.parametrize("M,V,keep", [(10, 5, ""), (128, 5, "tx"), (33, 17, ""),
                                      (128, 128, "rx"), (256, 200, "")])
def test_block_operands_match_cmatmul(M, V, keep):
    """K4's bf16 operands as the wrapper packs them for the tensor cores:
    phasors with (Re, Im) interleaved along the columns, times the
    real-block form of S_k (padded as tc_layout pads it), through a plain
    real float32 product, give cmatmul's bf16 product to float32 rounding.
    With keep 'rx' the third product's operand, the block of X_k^T, too."""
    rng = np.random.default_rng(61 + M + V)
    I, N = 37, 24
    th = rng.uniform(0, 2 * np.pi, (I, M))
    W = torch.as_tensor(np.exp(-1j * th).astype(np.complex64))
    S = torch.as_tensor((rng.standard_normal((M, V)) + 1j * rng.standard_normal((M, V)))
                        .astype(np.complex64))
    vt, Mp, Np, Vp, Vz = fdbf_cuda.tc_layout(M, N, V, keep)
    assert vt in (8, 16, 32, 64) and Vp % vt == 0 and Np % vt == 0
    assert Mp % fdbf_cuda.KROWS == 0 and Vz % fdbf_cuda.KROWS == 0 and V <= Vz <= Vp

    def left(z, cols):  # (Re, Im) interleaved along the columns, zero-padded
        z = fdbf.round_operand(z, "bf16")
        out = torch.zeros((z.shape[0], cols, 2))
        out[:, :z.shape[1]] = torch.view_as_real(z)
        return out.reshape(z.shape[0], 2 * cols)

    blk = fdbf_cuda.block_operand(S[None], Mp, Vp)[0]
    assert blk.dtype == torch.bfloat16 and blk.shape == (2 * Mp, 2 * Vp)
    got = torch.view_as_complex((left(W, Mp) @ blk.float()).reshape(I, Vp, 2).contiguous())
    ref = fdbf.cmatmul(W, S, "bf16")
    assert not bool(got[:, V:].abs().any())  # the padded columns stay zero
    assert float((got[:, :V] - ref).abs().max()) < 1e-6 * float(ref.abs().max())
    if keep == "rx":  # z = conj(Ahat) X_k^T with the block of X_k^T (V, N)
        X = torch.as_tensor((rng.standard_normal((N, V)) + 1j * rng.standard_normal((N, V)))
                            .astype(np.complex64))
        H = ref / ref.abs().amax()
        xb = fdbf_cuda.block_operand(X.T[None], Vp, Np)[0]
        z = torch.view_as_complex((left(H.conj(), Vz)[:, :2 * Vz] @ xb[:2 * Vz].float())
                                  .reshape(I, Np, 2).contiguous())[:, :N]
        zref = fdbf.cmatmul(H.conj(), X.T, "bf16")
        assert float((z - zref).abs().max()) < 1e-6 * float(zref.abs().max())


# K4(b): past 256 synthesized pulses, and keep_rx past 256 receivers
WIDE = {"sum V300": ("sum", dict(V=300, N=12)), "tx V300": ("tx", dict(V=300, N=12)),
        "rx N300": ("rx", dict(V=20, N=300)), "rx V300 N300": ("rx", dict(V=300, N=300))}
WIDE_BINS = np.array([5, 9, 10, 11, 17, 20])


@pytest.mark.parametrize("case", sorted(WIDE))
def test_bf_adjoint_wide_matches_xla(case):
    """300 pulses (and 300 receivers with keep_rx), 256 pixels, 6 bins: the
    plain version, and the K4 wrapper on a CPU tensor, against the XLA
    engine (2e-3, its direct cexp phases)."""
    keep, shape = WIDE[case]
    x, args = adjoint_problem(I=256, M=16, **shape)
    kw = dict(fs=FS, fmod=1e6, **KEEP[keep])
    ref = jfdbf.bf_adjoint(x, *args, WIDE_BINS.astype(np.int32), **kw)
    got = fdbf.bf_adjoint(torch.as_tensor(x), *args, WIDE_BINS, precision="f32", **kw)
    close(got, ref, 2e-3)
    wrapped = fdbf_cuda.bf_adjoint_cuda(torch.as_tensor(x), *args, WIDE_BINS,
                                        precision="f32", **kw)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("precision,tol", [("f32", 1e-4), ("bf16", 2e-3)])
@pytest.mark.parametrize("case", sorted(WIDE))
def test_bf_adjoint_wide_matches_pallas_interpret(case, precision, tol, monkeypatch):
    """The same problems against the TPU kernel in interpret mode (one
    block of 256 pixels), whose pulse and receiver axes are not capped:
    1e-4 in f32, the bf16 band in bf16."""
    monkeypatch.setenv("QUPS_ADJ_RECUR", "0")
    keep, shape = WIDE[case]
    x, args = adjoint_problem(I=256, M=16, **shape)
    kw = dict(fs=FS, fmod=1e6, **KEEP[keep])
    ref = bf_adjoint_tiled(x, *args, WIDE_BINS.astype(np.int32), precision=precision,
                           BI=256, interpret=True, **kw)
    close(fdbf.bf_adjoint(torch.as_tensor(x), *args, WIDE_BINS, precision=precision, **kw),
          ref, tol)


def _cu_source():
    from pathlib import Path

    return (Path(fdbf_cuda.__file__).parents[1] / "csrc" / "fdbf.cu").read_text()


def _cu_constants():
    """The constexpr ints of csrc/fdbf.cu's anonymous namespace."""
    import re

    src = _cu_source()
    consts = {}
    for name, expr in re.findall(r"^constexpr (?:int|size_t) (\w+) = ([\w +/-]+);", src,
                                 re.M):
        consts[name] = eval(expr, {}, dict(consts))  # BI = 64, GLD = KC + 8, ...
    return consts


def test_rx_chunk_plan_mirrors_the_kernel():
    """K4(b)'s chunk plan: the wrapper's copies of fdbf.cu's tile sizes,
    shared-memory limit and static row sums equal the source's; the plan
    keeps one pass while H of all V columns fits a block (V = 300 in both
    precisions) and otherwise takes the widest whole number of 64-column
    tiles with which two blocks share an SM (V = 1024: 256 columns in bf16,
    128 in f32), never above a block's limit."""
    c = _cu_constants()
    assert (c["BI"], c["GLD"], c["STAGES"], c["KC"], c["LC"], c["SMEM_LIMIT"]) == (
        fdbf_cuda.BI, fdbf_cuda.GLD, fdbf_cuda.STAGES, fdbf_cuda.KC, fdbf_cuda.LC,
        fdbf_cuda.SMEM_LIMIT)
    assert fdbf_cuda.KROWS == c["KC"] // 2
    assert "__shared__ float red[2][3][BI];" in _cu_source()
    lim, per_sm = fdbf_cuda.SMEM_LIMIT, fdbf_cuda.SM_SMEM

    def two_fit(*a):
        return 2 * (fdbf_cuda.rx_smem(*a) + fdbf_cuda.BLOCK_EXTRA) <= per_sm

    for precision in ("bf16", "f32"):
        assert fdbf_cuda.rx_chunk(1024, 300, precision) == 0
        for M, N, V in ((1024, 1024, 1024), (128, 300, 705), (16, 2000, 5000),
                        (1024, 1024, 300), (128, 128, 64), (900, 200, 24)):
            vh = fdbf_cuda.rx_chunk(N, V, precision)
            vp = fdbf_cuda.tc_layout(M, N, V, "rx")[3] if precision == "bf16" else V
            if vh == 0:
                assert fdbf_cuda.rx_smem(N, V, precision, vp) <= lim, (M, N, V, precision)
                continue
            assert fdbf_cuda.rx_smem(N, V, precision, vp) > lim
            assert vh % 64 == 0 and 64 <= vh < vp
            assert two_fit(N, V, precision, vh)
            assert not two_fit(N, V, precision, vh + 64)
    assert fdbf_cuda.rx_chunk(1024, 1024, "bf16") == 256
    assert fdbf_cuda.rx_chunk(1024, 1024, "f32") == 128
    # the bf16 engine's bytes as fdbf.cu's TcChunked counts them (NT = 8, GEN)
    assert fdbf_cuda.rx_smem(1024, 1024, "bf16", 256) == 2 * (
        2 * 64 * 40 + 64 * (2 * 256 + 8) + 3 * 32 * (16 * 8 + 8))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_rx_chunks_sum_to_the_one_pass(precision):
    """The algebra of K4(b)'s keep 'rx' chunks: conj(Ahat) by chunks of Vh
    columns, each chunk's Wrx z added into the output, gives the one-pass
    result to float32 rounding (Vh = 128 of V = 300: two full chunks and a
    ragged one)."""
    x, args = adjoint_problem(I=96, M=16, V=300, N=40)
    tau_rx, tau_tx, del_tx, apod, t0, t0o = args
    _, fk, Xk, Sk = fdbf.adjoint_spectra(torch.as_tensor(x), del_tx, apod, t0, t0o,
                                         WIDE_BINS, fs=FS)
    taur, taut = torch.as_tensor(tau_rx), torch.as_tensor(tau_tx)
    out = torch.zeros((96, 40), dtype=torch.complex64)
    for k in range(fk.shape[0]):
        A = fdbf.cmatmul(fdbf.phasor(fk[k], taut, -1.0), Sk[k], precision)
        nrm = torch.sqrt((A.real * A.real + A.imag * A.imag).sum(1, keepdim=True))
        Ah = A / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        Wrx = fdbf.phasor(fk[k], taur, 1.0)
        for v0 in range(0, 300, 128):
            out += Wrx * fdbf.cmatmul(Ah[:, v0:v0 + 128].conj(), Xk[k][:, v0:v0 + 128].T,
                                      precision)
    ref = fdbf.bf_adjoint(torch.as_tensor(x), *args, WIDE_BINS, keep_rx=True, fs=FS,
                          precision=precision)
    close(out, ref, 1e-5)
