"""Reduced-precision traces in the port (sub-slices K1(e), K2(e)): the
quantizers of ops/das_cuda.py bit for bit against the TPU package's packers
(``_pack_pairs``, the bf16 cast of ``prep_real``, ``_pack_quads``), the
plain versions of K1 and K2 at each precision against the TPU kernel in
interpret mode (``das_tiled``, ``das_lut_tiled``) at the TPU tests' sizes,
the precision bands against float32, the bfloat16 kept sums of
``QUPS_DAS_ACC16``, the ``ValueError``s of the TPU kernels, the i8x4 physics
oracle and the trace dtypes the kernels cast. The kernels themselves are
held to these plain versions on the card in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from qups_tpu.ops.das_pallas import (_pack_pairs, _pack_quads, das_lut_tiled,  # noqa: E402
                                     das_tiled)
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch.ops import das_cuda  # noqa: E402
from qups_tpu_torch.ops.interp import METHODS  # noqa: E402
from test_torch_das import assert_flips_only, geometry_delays64  # noqa: E402

CINV = np.float32(1 / 1540.0)
FS = 4e6
TOL = 1e-4  # the same rounded taps on both sides: float32 roundings only
# lanczos3: the TPU kernel forms its weights from folded trigonometry, within
# 1e-3 of the exact window (its own limit, tests/test_das_pallas.py)
TOL_METHOD = {"lanczos3": 1e-3}
BAND = 2e-2  # a reduced precision against float32, as the TPU tests hold it


def problem(T=256, N=16, M=4, I1=16, I2=128, cplx=False, seed=90):
    """tests/test_das_pallas.py's problem: white-noise traces, a 16 x 128
    z-major grid, a linear array and plane waves at +-9 degrees."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal((T, N, M))).astype(np.complex64)
    Z, X = np.meshgrid(np.linspace(5e-3, 45e-3, I1), np.linspace(-12e-3, 12e-3, I2),
                       indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)
    pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    th = np.radians(np.linspace(-9, 9, M))
    pv = np.zeros((M, 3), np.float32)
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1).astype(np.float32)
    t0 = np.full(M, 2 * 5e-3 / 1540.0, np.float32)
    return x, pi, pr, pv, nv, t0


def tables(pi, pr, nv, t0):
    """The TPU tests' LUT tables: receive distances and plane-wave transmit
    delays, t0 added back."""
    tau_rx = (np.linalg.norm(pi[:, None] - pr[None], axis=-1) / 1540.0).astype(np.float32)
    tau_tx = (pi @ nv.T / 1540.0 + t0[None, :]).astype(np.float32)
    return tau_rx, tau_tx


def with_ties(x):
    """``x`` with every 7th value moved onto an exact bfloat16 tie (low 16
    bits 0x8000), where rounding half away from zero and half to even
    differ for every other value."""
    b = x.view(np.int32).copy()
    b.reshape(-1)[::7] = (b.reshape(-1)[::7] & ~0xFFFF) | 0x8000
    return b.view(np.float32)


def _bits16(a):
    return np.asarray(a, np.int64) & 0xFFFF


def test_bf16pair_taps_bit_equal_pack_pairs():
    """'bf16pair': the port's rounding and its linear layout against the
    halves of _pack_pairs' words (lane t: bf16(x[t]) low, bf16(x[t+1])
    high, the last lane's high half 0), ties included."""
    x = with_ties(problem(T=64)[0])
    words = np.asarray(_pack_pairs(jnp.asarray(x.transpose(2, 1, 0)))).astype(np.int64)
    lo, hi = words & 0xFFFF, (words >> 16) & 0xFFFF  # (M, N, T)
    got = das_cuda.round_bf16_half_away(torch.as_tensor(x)).numpy()
    assert np.array_equal(got.view(np.int32) >> 16 & 0xFFFF, lo.transpose(2, 1, 0))
    assert np.array_equal(got.view(np.int32) & 0xFFFF, np.zeros_like(lo).transpose(2, 1, 0))
    lay = das_cuda.trace_layout_plain(torch.as_tensor(x), "linear", "bf16pair").numpy()
    assert lay.dtype == np.int16 and lay.shape == (4, 16, 64, 2)
    assert np.array_equal(_bits16(lay[..., 0]), lo)
    assert np.array_equal(_bits16(lay[..., :-1, 1]), hi[..., :-1])
    assert np.array_equal(_bits16(lay[..., -1, 1]), lo[..., -1])  # the edge replicated
    # half away from zero is not torch's half to even on the ties
    even = das_cuda.round_bf16_even(torch.as_tensor(x)).numpy()
    assert (even != got).sum() > 0.3 * x.size / 7


def test_bf16_taps_bit_equal_astype():
    """'bf16': half to even, as prep_real's astype(jnp.bfloat16), ties
    included; the nearest and cubic layouts hold those taps."""
    x = with_ties(problem(T=64, cplx=True)[0].real.copy())
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = das_cuda.round_taps(torch.as_tensor(x), "bf16").numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))
    near = das_cuda.trace_layout_plain(torch.as_tensor(x), "nearest", "bf16").numpy()
    assert np.array_equal(_bits16(near), ref.view(np.int32).transpose(2, 1, 0) >> 16 & 0xFFFF)
    cub = das_cuda.trace_layout_plain(torch.as_tensor(x), "cubic", "bf16").numpy()
    b = ref.view(np.int32).transpose(2, 1, 0) >> 16 & 0xFFFF
    pad = np.concatenate([b[..., :1], b, b[..., -1:], b[..., -1:]], -1)
    for j in range(4):
        assert np.array_equal(_bits16(cub[..., j]), pad[..., j:j + 64])


@pytest.mark.parametrize("cplx", [False, True])
def test_i8x4_taps_bit_equal_pack_quads(cplx):
    """'i8x4': the per-transmit scales (das_tiled's, numpy's complex
    magnitude), the per-call scale (das_lut_plan's) and the quantized taps
    against _pack_quads' bytes, on the edge-replicated trace the TPU path
    packs; the cubic layout holds the same four taps."""
    x = problem(T=64, cplx=cplx)[0]
    x[:, :, 2] *= np.float32(1e-3)  # transmits of other amplitudes keep their own scale
    xt = torch.as_tensor(x)
    per_tx = np.maximum(np.max(np.abs(x), axis=(0, 1)), 1e-30).astype(np.float32)
    s = das_cuda.i8_scale(xt)
    assert np.array_equal(s.numpy(), per_tx)
    per_call = das_cuda.i8_scale(xt, per_transmit=False).numpy()
    assert np.array_equal(per_call, np.full(4, np.float32(max(np.abs(x).max(), 1e-30))))
    q = das_cuda.round_taps(xt, "i8x4", s)
    parts = (x.real, x.imag) if cplx else (x,)
    qparts = (q.real, q.imag) if cplx else (q,)
    lay = das_cuda.trace_layout_plain(xt, "cubic", "i8x4", s).numpy()
    assert lay.dtype == np.int8 and lay.shape == (4, 16, 64) + ((2,) if cplx else ()) + (4,)
    for c, (xp, qp) in enumerate(zip(parts, qparts)):
        xe = np.concatenate([xp[:1], xp[:1], xp, xp[-1:], xp[-1:]], 0)  # x[-2 .. T+1]
        words, _ = _pack_quads(jnp.asarray(xe.transpose(2, 1, 0)),
                               scale=jnp.asarray(per_tx)[:, None, None])
        w = np.asarray(words).astype(np.int64)  # lane t: taps xe[t-1 .. t+2]
        taps = [((w >> (8 * j)) & 0xFF).astype(np.uint8).view(np.int8) for j in range(4)]
        assert np.array_equal(qp.numpy().transpose(2, 1, 0), taps[1][..., 2:-2])
        for j in range(4):  # entry k holds x[k-1 .. k+2] = xe[k+1 .. k+4]: lane k + 2
            got = lay[..., c, j] if cplx else lay[..., j]
            assert np.array_equal(got, taps[j][..., 2:66])


def _k1(x, pi, pr, pv, nv, t0, precision, **kw):
    """(the port's plain K1, the TPU kernel in interpret mode), numpy."""
    got = das_cuda.das_sum(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, fs=FS,
                           tx_model="plane", precision=precision, **kw).numpy()
    ref = np.asarray(das_tiled(x, pi, pr, pv, nv, t0, CINV, fs=FS, tx_model="plane",
                               im_shape=(16, 128, 1), interpret=True, precision=precision,
                               **kw))
    return got, ref.reshape(got.shape)


def _f32(x, pi, pr, pv, nv, t0, **kw):
    return das_cuda.das_sum(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, fs=FS,
                            tx_model="plane", **kw).numpy()


# (precision, method, trace kind, extra keywords) of K1's cases
K1_CASES = {f"bf16pair_{m}_{k}": ("bf16pair", m, k, {}) for m in METHODS
            for k in ("real", "complex", "fmod")}
K1_CASES.update({"bf16_linear_real": ("bf16", "linear", "real", {})})
K1_CASES.update({f"i8x4_{m}_{keep or 'sum'}": ("i8x4", m, "real", {keep: True} if keep else {})
                 for m in ("cubic", "lanczos3") for keep in ("", "keep_rx", "keep_tx")})


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_plain_matches_pallas_interpret(case):
    """K1's plain version at each precision against das_tiled(interpret=True)
    with the same precision: the same rounded taps, so within float32
    roundings (nearest: its delay flips attributed); each within the TPU
    tests' band of the float32 image."""
    precision, method, kind, extra = K1_CASES[case]
    x, pi, pr, pv, nv, t0 = problem(cplx=kind == "complex")
    kw = dict(method=method, fmod=1e6 if kind == "fmod" else 0.0, **extra)
    got, ref = _k1(x, pi, pr, pv, nv, t0, precision, **kw)
    assert got.dtype == (np.complex64 if kind != "real" else np.float32)
    scale = np.abs(ref).max()
    tol = TOL_METHOD.get(method, TOL)
    off = (np.abs(got - ref) >= tol * scale).reshape(got.shape[0], -1).any(1)
    if method == "nearest":
        assert_flips_only(off, *geometry_delays64(pi, pr, pv, nv, t0, CINV, FS, "plane"),
                          x.shape[0])
    else:
        assert not off.any(), np.abs(got - ref).max() / scale
    f32 = _f32(x, pi, pr, pv, nv, t0, **kw)
    assert np.abs(got - f32).max() < BAND * np.abs(f32).max()


def test_k1_i8x4_iq_shares_one_scale():
    """IQ + fmod with channels 20x apart: one scale per transmit covers both
    parts (the remodulation mixes them), as the TPU kernel takes it."""
    x, pi, pr, pv, nv, t0 = problem()
    rng = np.random.default_rng(91)
    xc = (x + 1j * (0.05 * rng.standard_normal(x.shape))).astype(np.complex64)
    got, ref = _k1(xc, pi, pr, pv, nv, t0, "i8x4", method="cubic", fmod=3e5)
    assert np.abs(got - ref).max() < TOL * np.abs(ref).max()
    f32 = _f32(xc, pi, pr, pv, nv, t0, method="cubic", fmod=3e5)
    assert np.abs(got - f32).max() < BAND * np.abs(f32).max()


def test_k1_i8x4_per_transmit_scale_resolution():
    """Transmits 60 dB apart each keep int8 resolution (the TPU test of the
    same name): keep_tx isolates each transmit's error."""
    x, pi, pr, pv, nv, t0 = problem()
    xa = (x * np.array([1.0, 1e-1, 1e-2, 1e-3], np.float32)).astype(np.float32)
    got, ref = _k1(xa, pi, pr, pv, nv, t0, "i8x4", method="cubic", keep_tx=True)
    f32 = _f32(xa, pi, pr, pv, nv, t0, method="cubic", keep_tx=True)
    for m in range(4):
        sl = np.s_[:, :, m]
        assert np.abs(got[sl] - ref[sl]).max() < TOL * np.abs(ref[sl]).max(), m
        assert np.abs(got[sl] - f32[sl]).max() < BAND * np.abs(f32[sl]).max(), m


# (precision, method, complex traces, fmod) of K2's cases
K2_CASES = {f"bf16pair_{m}": ("bf16pair", m, False, 0.0) for m in METHODS}
K2_CASES.update({"i8x4_cubic": ("i8x4", "cubic", False, 0.0),
                 "i8x4_lanczos3_iq_fmod": ("i8x4", "lanczos3", True, 3e5),
                 "bf16pair_cubic_iq_fmod": ("bf16pair", "cubic", True, 3e5)})


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_plain_matches_pallas_interpret(case):
    """K2's plain version against das_lut_tiled(interpret=True): 'bf16pair'
    and 'i8x4' with one scale per call; within the band of float32."""
    precision, method, cplx, fmod = K2_CASES[case]
    x, pi, pr, pv, nv, t0 = problem(cplx=cplx)
    tau_rx, tau_tx = tables(pi, pr, nv, t0)
    kw = dict(fs=FS, method=method, fmod=fmod)
    got = das_cuda.das_lut_sum(torch.as_tensor(x), tau_rx, tau_tx, t0, precision=precision,
                               **kw).numpy()
    ref = np.asarray(das_lut_tiled(x, tau_rx, tau_tx, t0, im_shape=(16, 128, 1),
                                   interpret=True, precision=precision, **kw))
    ref = ref.reshape(got.shape)
    scale = np.abs(ref).max()
    off = (np.abs(got - ref) >= TOL_METHOD.get(method, TOL) * scale).reshape(-1)
    if method == "nearest":  # the tables' delays: no geometry; flips at half-integers
        ti = ((tau_tx[:, :, None] + tau_rx[:, None, :]) - t0[None, :, None]).astype(
            np.float64) * np.float64(np.float32(FS))
        assert_flips_only(off, ti, np.abs(ti) + 1.0, x.shape[0])
    else:
        assert not off.any(), np.abs(got - ref).max() / scale
    f32 = das_cuda.das_lut_sum(torch.as_tensor(x), tau_rx, tau_tx, t0, **kw).numpy()
    assert np.abs(got - f32).max() < BAND * np.abs(f32).max()


@pytest.mark.parametrize("keep", ["keep_rx", "keep_tx"])
def test_acc16_kept_sums(keep, monkeypatch):
    """QUPS_DAS_ACC16=1: K1's kept sums in bfloat16, returned as float32:
    within the TPU test's 2e-2 of das_tiled's bfloat16 accumulator, each a
    bfloat16 value within its roundings of the float32 sums (keep_rx: one
    rounding a layout chunk, here one; keep_tx: one per chunk of 32
    receivers, here one)."""
    x, pi, pr, pv, nv, t0 = problem()
    kw = dict(method="linear", **{keep: True})
    f32 = _f32(x, pi, pr, pv, nv, t0, **kw)
    monkeypatch.setenv("QUPS_DAS_ACC16", "1")
    got, ref = _k1(x, pi, pr, pv, nv, t0, "f32", **kw)
    assert got.dtype == np.float32 and ref.dtype == np.float32
    assert np.abs(got - ref).max() < BAND * np.abs(ref).max()
    assert np.array_equal(got, das_cuda.round_bf16_even(torch.as_tensor(got)).numpy())
    assert np.all(np.abs(got - f32) <= 2.0 ** -8 * np.abs(f32))
    # at a reduced precision the taps round first, then the sums
    q = _f32(x, pi, pr, pv, nv, t0, precision="bf16pair", **kw)
    monkeypatch.setenv("QUPS_DAS_ACC16", "0")
    q16 = _f32(x, pi, pr, pv, nv, t0, precision="bf16pair", **kw)
    assert np.all(np.abs(q - q16) <= 2.0 ** -8 * np.abs(q16))


def test_acc16_rounds_once_a_chunk(monkeypatch):
    """keep_rx by layout chunks: the stored sums round after each chunk's
    transmits are added, as K1 stores them once a launch."""
    x, pi, pr, pv, nv, t0 = problem()
    monkeypatch.setenv("QUPS_DAS_ACC16", "1")
    monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", 2 * 4 * 2 * 256 * 16)  # 2 transmits a chunk
    assert das_cuda.tx_chunks(torch.as_tensor(x), "linear") == [(0, 2), (2, 4)]
    kw = dict(fs=FS, tx_model="plane", method="linear", keep_rx=True)
    got = das_cuda.das_sum(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, **kw)
    monkeypatch.setenv("QUPS_DAS_ACC16", "0")
    a, b = (das_cuda.das_sum(torch.as_tensor(x[:, :, m]), pi, pr, pv[m], nv[m], t0[m], CINV,
                             **kw) for m in (slice(0, 2), slice(2, 4)))
    r = das_cuda.round_bf16_even
    assert torch.equal(got, r(r(a) + b))


def test_precision_value_errors():
    """Where the TPU kernels raise ValueError, the port raises it too, on
    the CPU and before any launch: 'i8x4' with nearest or linear (and so
    cubic2x, which becomes linear), 'bf16' on K2, an unknown precision."""
    x, pi, pr, pv, nv, t0 = problem(T=64)
    xt = torch.as_tensor(x)
    tau_rx, tau_tx = tables(pi, pr, nv, t0)
    for method in ("nearest", "linear"):
        with pytest.raises(ValueError, match="4-tap"):
            das_cuda.das_sum(xt, pi, pr, pv, nv, t0, CINV, fs=FS, method=method,
                             precision="i8x4")
        with pytest.raises(ValueError, match="4-tap"):
            das_cuda.das_lut_sum(xt, tau_rx, tau_tx, t0, fs=FS, method=method,
                                 precision="i8x4")
        with pytest.raises(ValueError):
            das_tiled(x, pi, pr, pv, nv, t0, CINV, fs=FS, method=method, precision="i8x4",
                      im_shape=(16, 128, 1), interpret=True)
    with pytest.raises(ValueError, match="unknown precision 'bf16'"):
        das_cuda.das_lut_sum(xt, tau_rx, tau_tx, t0, fs=FS, precision="bf16")
    with pytest.raises(ValueError, match="unknown precision 'bf16'"):
        das_lut_tiled(x, tau_rx, tau_tx, t0, fs=FS, im_shape=(16, 128, 1), interpret=True,
                      precision="bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        das_cuda.das_sum(xt, pi, pr, pv, nv, t0, CINV, fs=FS, precision="fp8")
    with pytest.raises(ValueError, match="4-tap"):
        das_cuda.trace_layout_plain(xt, "linear", "i8x4", das_cuda.i8_scale(xt))


def test_i8x4_psf_oracle():
    """The FSA point target through K1's plain version in 'i8x4' (the
    system's geometry and traces): the PSF peak within 1.1 mm."""
    xdc = qt.TransducerArray(numel=8, pitch=0.3e-3, fc=5e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=8),
        scan=qt.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 32),
                              z=np.linspace(17e-3, 23e-3, 32)), fs=25e6)
    chd = us.greens(qt.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0), device="cpu")
    pvs, nvs, model = us._tx_geometry()
    img = das_cuda.das_sum(chd.data, us._pixels(), us.rx.positions().T, pvs, nvs, chd.t0,
                           CINV, fs=float(chd.fs), tx_model=model, method="cubic",
                           precision="i8x4")
    P = us.scan.positions().reshape(3, -1)
    k = int(img.abs().reshape(-1).argmax())
    assert np.linalg.norm(P[:, k] - [0, 0, 20e-3]) < 1.1e-3


@pytest.mark.parametrize("dtype", ["float64", "complex128", "bfloat16"])
def test_trace_dtypes_are_cast(dtype):
    """float64, complex128 and bfloat16 traces give the image of their
    float32 or complex64 cast (the TPU path's _upload_trace, prep_real),
    through K1 and K2 at each precision; no launch on the CPU."""
    x, pi, pr, pv, nv, t0 = problem(T=64, cplx=dtype == "complex128")
    wide = torch.as_tensor(x).to(getattr(torch, dtype))
    cast = wide.to(torch.complex64 if wide.is_complex() else torch.float32)
    tau_rx, tau_tx = tables(pi, pr, nv, t0)
    before = das_cuda.PREC_LAUNCHES, das_cuda.LUT_PREC_LAUNCHES, das_cuda.LAUNCHES
    for precision in ("f32", "bf16pair", "i8x4"):
        kw = dict(fs=FS, method="cubic", precision=precision)
        got = das_cuda.das_sum(wide, pi, pr, pv, nv, t0, CINV, tx_model="plane", **kw)
        assert got.dtype == cast.dtype
        assert torch.equal(got, das_cuda.das_sum(cast, pi, pr, pv, nv, t0, CINV,
                                                 tx_model="plane", **kw))
        got = das_cuda.das_lut_sum(wide, tau_rx, tau_tx, t0, **kw)
        assert got.dtype == cast.dtype
        assert torch.equal(got, das_cuda.das_lut_sum(cast, tau_rx, tau_tx, t0, **kw))
    assert (das_cuda.PREC_LAUNCHES, das_cuda.LUT_PREC_LAUNCHES, das_cuda.LAUNCHES) == before


def test_tx_chunks_count_entry_bytes(monkeypatch):
    """The layout budget counts each entry form's real bytes: at a budget
    that holds one float32 cubic transmit, the rounded taps' forms take two
    (bf16) or four (int8) a chunk, the float32 coefficients of rounded taps
    (the plan's form for real cubic bf16 traces, and for real cubic int8
    ones in the keep kernel) one, the int8 taps' half-precision
    coefficients (the summed kernels' cubic 'i8x4') two; each chunk's
    layout, as trace_layout_plain writes it, fits the budget."""
    x = torch.zeros((256, 16, 4))
    xc = torch.zeros((256, 16, 4), dtype=torch.complex64)
    budget = 4 * 4 * 256 * 16
    monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", budget)
    assert len(das_cuda.tx_chunks(x, "cubic")) == 4
    assert len(das_cuda.tx_chunks(x, "cubic", "bf16pair", "bf16")) == 2
    assert len(das_cuda.tx_chunks(x, "cubic", "i8x4", "i8")) == 1
    for precision in ("bf16pair", "bf16", "i8x4"):  # the plan's forms
        for keep in (False, True):
            form = das_cuda.entry_form("cubic", precision, False, keep)
            assert form == ("h16" if precision == "i8x4" and not keep else "f32c")
            assert len(das_cuda.tx_chunks(x, "cubic", precision, form)) == (
                2 if form == "h16" else 4)
        assert len(das_cuda.tx_chunks(x, "cubic", precision)) == (
            2 if precision == "i8x4" else 4)
        assert len(das_cuda.tx_chunks(x, "cubic", precision, "f32c")) == 4
    assert len(das_cuda.tx_chunks(xc, "cubic", "i8x4")) == 4  # h16: 16 bytes a tap base
    assert len(das_cuda.tx_chunks(xc, "cubic", "bf16pair")) == 4
    assert len(das_cuda.tx_chunks(xc, "lanczos3", "i8x4")) == 2
    assert len(das_cuda.tx_chunks(x, "linear", "bf16pair")) == 1
    s = das_cuda.i8_scale(x + 1.0)
    for xx in (x, xc):
        for precision in ("bf16pair", "i8x4"):
            for method, keep in (("cubic", False), ("cubic", True), ("lanczos3", False)):
                form = das_cuda.entry_form(method, precision, xx.is_complex(), keep)
                for m0, m1 in das_cuda.tx_chunks(xx, method, precision, form):
                    lay = das_cuda.trace_layout_plain(xx[:, :, m0:m1] + 1.0, method, precision,
                                                      s[m0:m1], form)
                    assert 0 < lay.numel() * lay.element_size() <= budget
