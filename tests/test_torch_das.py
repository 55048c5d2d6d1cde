"""The port's delay-and-sum (qups_tpu_torch.ops.das.das, the plain version
of kernel K1) against qups_tpu's das for 3 transmit models x 4 samplers,
cases against the Pallas kernel das_tiled in interpret mode (among them
frames and IQ remodulation, sub-slice K1(b)), the wrapper's CPU path, the
trace layouts K1 and K2 read (against the clamped gather of
ops/interp.py, with frames too), the chunks of transmits, and which
options the kernels leave to later sub-slices. K1 itself is tested on the
card in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qups_tpu.ops.das import das as das_ref  # noqa: E402
from qups_tpu.ops.das import delay_tables as delay_tables_ref  # noqa: E402
from qups_tpu.ops.das_pallas import das_tiled  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch.ops import das_cuda, interp  # noqa: E402
from qups_tpu_torch.ops.das import das, delay_tables  # noqa: E402
from qups_tpu_torch.ops.interp import METHODS  # noqa: E402

CINV = np.float32(1 / 1540.0)


def problem(model, T=256, N=16, M=4, I1=16, I2=32, seed=20, cplx=False):
    """Random traces and a z-major pixel grid; t0 puts some delays below 0
    and some above T-1 at fs = 4 MHz."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal((T, N, M))).astype(np.complex64)
    Z, X = np.meshgrid(np.linspace(5e-3, 45e-3, I1), np.linspace(-12e-3, 12e-3, I2),
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


def geometry_delays64(pi, pr, pv, nv, t0, cinv, fs, model):
    """Every term's fractional sample index ti (I, M, N) in float64 from the
    same float32 inputs, with fs rounded to float32 as the samplers take it:
    ti = (cinv (dv + dr) - t0) fs. Also the size of the largest value on
    the way, (cinv (|dv| + dr) + |t0|) fs, per term."""
    p, r, v, d = (np.asarray(a, np.float64) for a in (pi, pr, pv, nv))
    dr = np.linalg.norm(p[:, None] - r[None], axis=-1)[:, None, :]  # (I, 1, N)
    rv = p[:, None] - v[None]  # (I, M, 3)
    dot = (rv * d[None]).sum(-1)
    dv = dot if model == "plane" else np.linalg.norm(rv, axis=-1)
    if model == "virtual":
        dv = np.copysign(dv, dot)
    c, t, f = np.float64(cinv), np.asarray(t0, np.float64)[None, :, None], \
        np.float64(np.float32(fs))
    return (c * (dv[:, :, None] + dr) - t) * f, (c * (np.abs(dv)[:, :, None] + dr)
                                                 + np.abs(t)) * f


def steady(side, evaluate):
    """``evaluate()`` (a numpy array) evaluated twice, which must agree bit
    for bit: a test that compares the port with the JAX package holds each
    side to one value, and names the side that moved.

    The port's plain das once moved here: on a process's first call, one
    chunk of 2048 receive distances came back ~3e-4 off (torch's CPU sqrt
    runs MKL's vector math over the intra-op threads, whose first call in
    a process can go wrong; qups_tpu_torch/utils/backend.py now sets it up
    on import), and the nearest sampler took other samples for a block of
    128 pixels. The JAX reference never moved."""
    a, b = evaluate(), evaluate()
    moved = np.flatnonzero((a != b).reshape(a.shape[0], -1).any(1))
    assert not moved.size, f"{side} gave two values on the same inputs, pixels {moved}"
    return a


def assert_flips_only(off, ti, scale, T):
    """Nearest-sampler attribution: a pixel may be off (differ from the
    reference by more than the limit) only if one of its terms (ti, exact
    fractional sample indices) lies within eps of a half-integer, where
    nearest rounds to the other side, or of 0 or T-1, where the term enters
    or leaves the sum.

    eps bounds how far a float32 evaluation of ti, in any order and with or
    without FMAs, can be from the exact value: each of its ~16 roundings
    (differences, squares, sums, square roots, the products with cinv and
    fs, the subtraction of t0) moves ti by at most 2^-24 of ``scale``, the
    largest value on the way in samples; eps allows twice that."""
    eps = 32 * 2.0 ** -24 * float(scale.max())
    inside = (ti > -eps) & (ti < T - 1 + eps)
    near = (np.abs(ti) < eps) | (np.abs(ti - (T - 1)) < eps) \
        | (inside & (np.abs(ti - np.floor(ti) - 0.5) < eps))
    excused = near.reshape(ti.shape[0], -1).any(1)
    assert not (off & ~excused).any(), (np.flatnonzero(off & ~excused), eps)
    assert excused.mean() < 0.25, (excused.mean(), eps)  # eps stays a thin band


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("model", ["plane", "diverging", "virtual"])
def test_das_matches_reference(model, method):
    x, pi, pr, pv, nv, t0 = problem(model)
    kw = dict(fs=4e6, tx_model=model, method=method)
    ref = steady("the JAX reference",
                 lambda: np.asarray(das_ref(x, pi, pr, pv, nv, t0, CINV, **kw)))
    got = steady("the port", lambda: das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV,
                                         **kw).numpy())
    assert got.shape == ref.shape == (pi.shape[0], 1, 1)
    off = (np.abs(got - ref) >= 1e-4 * np.abs(ref).max()).reshape(-1)
    if method == "nearest":
        # XLA on the CPU may contract the reference's delay arithmetic into
        # FMAs, depending on the CPU it compiles for, and torch's CPU sqrt
        # (MKL's) is within an ulp, not always correctly rounded, so the two
        # sides' float32 delays may differ in the last bits; where a delay lies
        # that close to a half-integer, or to 0 or T-1, nearest takes another
        # sample (or none). Only such pixels may differ.
        assert_flips_only(off, *geometry_delays64(pi, pr, pv, nv, t0, CINV, 4e6, model),
                          x.shape[0])
    else:
        assert not off.any()


@pytest.mark.parametrize("model", ["plane", "diverging", "virtual"])
def test_delay_tables(model):
    x, pi, pr, pv, nv, t0 = problem(model)
    for got, ref in zip(delay_tables(pi, pr, pv, nv, 1540.0, model, device="cpu"),
                        delay_tables_ref(pi, pr, pv, nv, 1540.0, model)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() < 1e-4 * np.abs(ref).max()


def test_das_matches_pallas_interpret():
    """The port against the TPU kernel itself, run as the JAX package's own
    tests run it on the CPU (interpret mode; 128-wide iso-depth rows)."""
    x, pi, pr, pv, nv, t0 = problem("plane", I1=8, I2=128)
    ref = np.asarray(das_tiled(x, pi, pr, pv, nv, t0, CINV, fs=4e6,
                               tx_model="plane", method="cubic",
                               im_shape=(8, 128, 1), interpret=True)).squeeze()
    got = das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, fs=4e6,
              tx_model="plane", method="cubic").numpy().squeeze()
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def frame_traces(x, fdims, cplx, seed=23):
    """Traces (T, N, M, *fdims): frame 0 is ``x`` (made complex with a
    random imaginary part when ``cplx``), the others seeded draws."""
    rng = np.random.default_rng(seed)
    xf = rng.standard_normal(x.shape + tuple(fdims)).astype(np.float32)
    if cplx:
        xf = (xf + 1j * rng.standard_normal(xf.shape)).astype(np.complex64)
    xf.reshape(x.shape + (-1,))[..., 0] = x
    return xf


# (frame dims, complex traces, fmod): K1(b)'s and K2(b)'s cases
IQ_CASES = {"real_fmod_F3": ((3,), False, 1e6), "complex_fmod_F3": ((3,), True, 1e6),
            "complex_F3": ((3,), True, 0.0), "complex_fmod_F2x3": ((2, 3), True, 1.5e6),
            "real_F2x3": ((2, 3), False, 0.0)}


@pytest.mark.parametrize("case", sorted(IQ_CASES))
def test_das_frames_fmod_match_pallas_interpret(case):
    """Frames and IQ remodulation (sub-slice K1(b)) in the plain das, the
    version K1 is held to on the card, against the TPU kernel in interpret
    mode."""
    fdims, cplx, fmod = IQ_CASES[case]
    x, pi, pr, pv, nv, t0 = problem("plane", I1=8, I2=128)
    xf = frame_traces(x, fdims, cplx)
    kw = dict(fs=4e6, tx_model="plane", method="cubic", fmod=fmod)
    ref = np.asarray(das_tiled(xf, pi, pr, pv, nv, t0, CINV, im_shape=(8, 128, 1),
                               interpret=True, **kw))
    got = das(torch.as_tensor(xf), pi, pr, pv, nv, t0, CINV, **kw).numpy()
    assert got.shape == (pi.shape[0], 1, 1) + fdims
    assert got.dtype == (np.complex64 if cplx or fmod else np.float32)
    ref = ref.reshape(got.shape)
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
    # each frame is the one-frame image of its traces
    x3 = xf.reshape(xf.shape[:3] + (-1,))[..., -1]
    one = das(torch.as_tensor(x3), pi, pr, pv, nv, t0, CINV, **kw).numpy()
    assert np.abs(got.reshape(got.shape[:3] + (-1,))[..., -1] - one).max() \
        < 1e-6 * np.abs(one).max()


@pytest.mark.parametrize("case", ["keep_rx", "keep_tx", "apod_fmod_complex"])
def test_das_general_modes(case):
    """The plain path carries the modes that K1 leaves to later sub-slices."""
    x, pi, pr, pv, nv, t0 = problem("virtual", cplx=case == "apod_fmod_complex")
    kw = dict(fs=4e6, tx_model="virtual", method="linear")
    if case == "keep_rx":
        kw["keep_rx"] = True
    elif case == "keep_tx":
        kw["keep_tx"] = True
    else:
        rng = np.random.default_rng(21)
        kw.update(fmod=1e6, im_shape=(16, 32, 1),
                  apod=(rng.uniform(size=(16, 1, 1, 16, 1)).astype(np.float32),
                        rng.uniform(size=(1, 32, 1, 1, 4)).astype(np.float32)))
    ref = np.asarray(das_ref(x, pi, pr, pv, nv, t0, CINV, **kw))
    got = das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, **kw).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def test_das_sum_cpu_is_plain():
    """On a CPU tensor the K1 wrapper runs the plain version and launches
    nothing."""
    x, pi, pr, pv, nv, t0 = problem("plane")
    before = das_cuda.LAUNCHES
    args = (torch.as_tensor(x), pi, pr, pv, nv, t0, CINV)
    kw = dict(fs=4e6, tx_model="plane", method="cubic")
    got = das_cuda.das_sum(*args, **kw)
    assert torch.equal(got, das_cuda.das_sum_plain(*args, **kw))
    assert torch.equal(got, das(*args, **kw))
    assert das_cuda.LAUNCHES == before



@pytest.mark.parametrize("case", sorted(IQ_CASES))
def test_das_sum_frames_fmod_cpu_is_plain(case):
    """On a CPU tensor the K1 wrapper takes frames and fmod to the plain
    version, with no launch; a t0 that varies over frames or receivers is
    refused, as the kernel refuses it."""
    fdims, cplx, fmod = IQ_CASES[case]
    x, pi, pr, pv, nv, t0 = problem("virtual")
    xf = torch.as_tensor(frame_traces(x, fdims, cplx))
    before = das_cuda.LAUNCHES, das_cuda.LAYOUT_LAUNCHES
    kw = dict(fs=4e6, tx_model="virtual", method="linear", fmod=fmod)
    got = das_cuda.das_sum(xf, pi, pr, pv, nv, t0[None, None], CINV, **kw)
    assert torch.equal(got, das(xf, pi, pr, pv, nv, t0, CINV, **kw))
    assert got.shape == (pi.shape[0], 1, 1) + fdims
    assert (das_cuda.LAUNCHES, das_cuda.LAYOUT_LAUNCHES) == before
    for bad in (np.zeros((1, 16, 4), np.float32), np.zeros((1, 1, 4, 3), np.float32)):
        with pytest.raises(ValueError, match="receivers or frames"):
            das_cuda.das_sum(xf, pi, pr, pv, nv, bad, CINV, **kw)


def test_kernels_leave_c_d_e_to_later_sub_slices():
    """K1 and K2 carry every sub-slice now: frames and fmod (b), keep modes
    and apodization (c), (d), and the trace precisions and dtypes (e). On
    the CPU their wrappers take each precision to its plain version and
    cast float64 traces to float32, with no launch; the beamformers'
    precision 'auto' is float32 on every device."""
    x, pi, pr, pv, nv, t0 = problem("plane", T=64)
    x64 = torch.as_tensor(x.astype(np.float64))
    tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, 1540.0, "plane", device="cpu")
    counts = lambda: (das_cuda.LAUNCHES, das_cuda.LUT_LAUNCHES,  # noqa: E731
                      das_cuda.PREC_LAUNCHES, das_cuda.LUT_PREC_LAUNCHES,
                      das_cuda.LAYOUT_LAUNCHES)
    before = counts()
    for precision in das_cuda.PRECISIONS:
        kw = dict(fs=4e6, method="cubic", precision=precision)
        got = das_cuda.das_sum(x64, pi, pr, pv, nv, t0, CINV, tx_model="plane", **kw)
        assert got.dtype == torch.float32
        assert torch.equal(got, das_cuda.das_sum_plain(torch.as_tensor(x), pi, pr, pv, nv, t0,
                                                       CINV, tx_model="plane", **kw))
        if precision != "bf16":
            got = das_cuda.das_lut_sum(x64, tau_rx, tau_tx, t0, **kw)
            assert got.dtype == torch.float32
            assert torch.equal(got, das_cuda.das_lut_sum_plain(torch.as_tensor(x), tau_rx,
                                                               tau_tx, t0, **kw))
    assert counts() == before
    assert qt.system._kernel_precision("auto") == "f32"
    assert not hasattr(qt.UltrasoundSystem, "_ineligible")


def test_trace_layout_cpu_is_plain():
    """On the CPU the wrapper's layout, of all transmits or of a chunk of
    them, is its plain version: no launch."""
    x = torch.as_tensor(np.random.default_rng(22).standard_normal((9, 3, 5)).astype(np.float32))
    before = das_cuda.LAYOUT_LAUNCHES
    for method in METHODS:
        assert torch.equal(das_cuda.trace_layout(x, method),
                           das_cuda.trace_layout_plain(x, method))
        assert torch.equal(das_cuda.trace_layout(x, method, 1, 4),
                           das_cuda.trace_layout_plain(x[..., 1:4], method))
    assert das_cuda.LAYOUT_LAUNCHES == before


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("method", METHODS)
def test_tx_chunks_bound_the_layout(method, cplx, monkeypatch):
    """K1's and K2's chunks of transmits cover every transmit once, in
    order, as few as keep each chunk's layout within LAYOUT_BYTES (one
    transmit where that alone is larger), and one chunk at the default
    budget for the headline's real traces."""
    dtype = torch.complex64 if cplx else torch.float32
    x = torch.zeros((9, 3, 7), dtype=dtype)
    per_tx = das_cuda.trace_layout_plain(x[..., :1], method).numel() \
        * (8 if method == "nearest" and cplx else 4)
    for budget, k in ((per_tx // 2, 7), (per_tx, 7), (2 * per_tx, 4), (3 * per_tx + 1, 3),
                      (7 * per_tx, 1), (1 << 40, 1)):
        monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", budget)
        got = das_cuda.tx_chunks(x, method)
        assert len(got) == k
        assert [m for c in got for m in range(*c)] == list(range(7))
        assert max(m1 - m0 for m0, m1 in got) - min(m1 - m0 for m0, m1 in got) <= 1
        if budget >= per_tx:
            assert all((m1 - m0) * per_tx <= budget for m0, m1 in got)
    monkeypatch.undo()
    if not cplx:
        head = torch.empty((4096, 256, 256), dtype=dtype, device="meta")
        assert das_cuda.tx_chunks(head, method) == [(0, 256)]


def kernel_reads(xl, method, tau):
    """What K1 and K2 read from the trace layout of ``method`` for the
    fractional indices ``tau`` (L,), as csrc/das.cu::sample indexes it: a
    list of (L, N, M) tensors of the trace type, the sample (nearest) or the
    floats of a stencil entry (complex: the real part's entry and the
    imaginary part's, as one complex tensor)."""
    if method == "nearest":  # the traces, sample round(tau)
        return [xl[:, :, torch.round(tau).long()].permute(2, 1, 0)]
    e = xl[:, :, torch.floor(tau).long()]  # (M, N, L, floats) or, complex, (M, N, L, 2, floats)
    if e.ndim == 5:
        return [torch.complex(e[..., 0, j], e[..., 1, j]).permute(2, 1, 0)
                for j in range(e.shape[-1])]
    return [e[..., j].permute(2, 1, 0) for j in range(e.shape[-1])]


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("T", [1, 2, 3, 7])
def test_trace_layout_reads_clamped_taps(T, method, cplx):
    """The kernels' trace layouts, read at every tap base in [0, T-1] with
    no clamp, give exactly the sample that ops/interp.py gathers with its
    index clamped to [0, T-1] (nearest), or the stencil entry
    of the taps it gathers so (das_cuda.stencil_entry of x[k-1..k+2],
    clamped)."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, 3, 2)).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    x = torch.as_tensor(x)
    xl = das_cuda.trace_layout(x, method)
    assert xl.is_contiguous() and xl.dtype == (x.dtype if method == "nearest"
                                               else torch.float32)
    tau = torch.tensor(sorted({min(k + f, T - 1.0) for k in range(T)
                               for f in (0.0, 0.25, 0.5, 0.75)}), dtype=torch.float32)
    b, offs, _, valid = interp._taps(tau, method, T)
    assert bool(valid.all())
    bases = torch.round(tau) if method == "nearest" else torch.floor(tau)
    assert set(bases.long().tolist()) == set(range(T))  # every base in [0, T-1]
    got = kernel_reads(xl, method, tau)
    if method == "nearest":
        want = [interp._gather_time(x, torch.clamp(b + o, 0, T - 1)) for o in offs]
    else:
        k = bases.long()
        taps = [interp._gather_time(x, torch.clamp(k + j, 0, T - 1)) for j in (-1, 0, 1, 2)]
        if cplx:  # the entry of the real part and of the imaginary part
            want = [torch.complex(*e.unbind(-1)) for e in das_cuda.stencil_entry(
                [torch.view_as_real(t) for t in taps], method)]
        else:
            want = das_cuda.stencil_entry(taps, method)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fdims", [(3,), (2, 2)], ids=["F3", "F2x2"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("method", METHODS)
def test_trace_layout_frames_reads_clamped_taps(method, cplx, fdims):
    """With frames, the layout holds a term's frames next to each other,
    (M, N, T, F, [2,] entry): frame f of it, read at every tap base with
    no clamp, gives what ops/interp.py gathers from frame f's traces with
    its index clamped to [0, T-1]; a chunk of transmits is the same
    chunk's layout."""
    T = 7
    rng = np.random.default_rng(24)
    x = rng.standard_normal((T, 3, 2) + fdims).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    xF = torch.as_tensor(x).reshape(T, 3, 2, -1)
    xl = das_cuda.trace_layout(xF, method)
    F = xF.shape[3]
    assert xl.is_contiguous() and tuple(xl.shape[:4]) == (2, 3, T, F)
    tau = torch.arange(T * 4, dtype=torch.float32) / 4
    tau = tau[tau <= T - 1]
    bases = (torch.round(tau) if method == "nearest" else torch.floor(tau)).long()
    for f in range(F):
        x = xF[..., f]
        got = kernel_reads(xl[:, :, :, f], method, tau)
        taps = [interp._gather_time(x, torch.clamp(bases + j, 0, T - 1)) for j in (-1, 0, 1, 2)]
        if method == "nearest":
            want = taps[1:2]
        elif cplx:
            want = [torch.complex(*e.unbind(-1)) for e in das_cuda.stencil_entry(
                [torch.view_as_real(t) for t in taps], method)]
        else:
            want = das_cuda.stencil_entry(taps, method)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert torch.equal(das_cuda.trace_layout(xF, method, 1, 2),
                       das_cuda.trace_layout_plain(xF[:, :, 1:2], method))


@pytest.mark.parametrize("method", METHODS)
def test_tx_chunks_count_the_frames(method, monkeypatch):
    """A transmit's layout holds all its frames: the chunks shrink with the
    frame count and each stays within LAYOUT_BYTES."""
    x = torch.zeros((9, 3, 7, 2, 3), dtype=torch.complex64)
    per_tx = das_cuda.trace_layout_plain(x.reshape(9, 3, 7, 6)[:, :, :1], method).numel() \
        * (8 if method == "nearest" else 4)
    monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", 2 * per_tx)
    got = das_cuda.tx_chunks(x, method)
    assert len(got) == 4 and [m for c in got for m in range(*c)] == list(range(7))
    assert all((m1 - m0) * per_tx <= 2 * per_tx for m0, m1 in got)
    assert das_cuda.tx_chunks(x[..., :1, :1], method) == [(0, 7)]
    monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", 6 * per_tx)
    assert len(das_cuda.tx_chunks(x, method)) == 2
    assert len(das_cuda.tx_chunks(x[..., :1, :1], method)) == 1


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3"])
def test_stencil_entry_interpolates_as_interp(method):
    """A stencil entry evaluated as the kernels evaluate it (linear and
    cubic: the polynomial in u of its floats; lanczos3: the taps with
    ops/interp.py's weights) gives ops/interp.py's sample at k + u, to
    float32 rounding."""
    rng = np.random.default_rng(21)
    taps = [torch.as_tensor(rng.standard_normal(4096).astype(np.float32)) for _ in range(4)]
    u = torch.as_tensor(rng.uniform(0, 1, 4096).astype(np.float32))
    e = [v.double() for v in das_cuda.stencil_entry(taps, method)]
    _, offs, w, _ = interp._taps(u, method, 8)  # base 0: taps at x[-1 .. 2] or x[0 .. 1]
    ref = sum(wj.double() * taps[o + (1 if method == "linear" else 0)].double()
              for wj, o in zip(w, offs))
    if method == "lanczos3":
        got = sum(wj.double() * v for wj, v in zip(w, e))
    else:
        ud = u.double()
        got = torch.zeros_like(ud)
        for c in reversed(e):
            got = got * ud + c
    assert float((got - ref).abs().max()) < 1e-6 * float(ref.abs().max())
