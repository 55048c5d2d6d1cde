"""The entry forms of K1(e) and K2(e)'s layouts on the CPU: what the layout
holds in each form (the float32 cubic coefficients of the rounded taps,
'f32c'; the int8 taps' coefficients in half precision, 'h16'; the
rounded taps) against ``stencil_entry(round_taps(x))``, bit for bit; that
half precision holds the int8 taps' coefficients exactly; the image a
kernel's arithmetic reads from each form against the TPU kernel in
interpret mode; the wrapper's plan (which form a sampler, precision, trace
type and frame count take) against csrc/das.cu's ``reads``; and the
launches the card path makes for each form, with a recorder for the
kernels. The kernels themselves run in tests/test_torch_cuda.py."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qups_tpu.ops.das_pallas import das_lut_tiled, das_tiled  # noqa: E402
from qups_tpu_torch.ops import _nvcc, das_cuda  # noqa: E402
from qups_tpu_torch.ops.das import rx_distance, tx_distance  # noqa: E402
from qups_tpu_torch.ops.interp import METHODS, _lanczos_w  # noqa: E402
from test_torch_precision import CINV, FS, TOL, TOL_METHOD, problem, tables  # noqa: E402

DAS_CU = Path(das_cuda.__file__).resolve().parents[1] / "csrc" / "das.cu"
PREC_METHODS = {"bf16pair": METHODS, "bf16": METHODS, "i8x4": ("cubic", "lanczos3")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests (the suite runs several
    workers); restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traces(T, N, M, fd, cplx, seed):
    rng = np.random.default_rng(seed)
    shape = (T, N, M) + fd
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.logspace(0, -3, M, dtype=np.float32).reshape((1, 1, M) + (1,) * len(fd))
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return torch.as_tensor(x)


def _stencils(xq, method):
    """stencil_entry of the taps x[clamp(k + j, 0, T - 1)], j = -1..2, of
    the rounded traces ``xq (T, N, M[, F])``, gathered with clamped indices:
    (M, N, T[, F], [2,] E) float32."""
    T = xq.shape[0]
    xr = torch.view_as_real(xq) if xq.is_complex() else xq[..., None]
    k = torch.arange(T)
    taps = [xr[torch.clamp(k + j, 0, T - 1)] for j in (-1, 0, 1, 2)]  # (T, N, M[, F], C)
    s = torch.stack(das_cuda.stencil_entry(taps, method), -1)
    s = s.permute(2, 1, 0, *range(3, s.ndim))
    return s if xq.is_complex() else s[..., 0, :]


@pytest.mark.parametrize("fd", [(), (3,)], ids=["one_frame", "frames"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("precision", ["bf16pair", "bf16", "i8x4"])
def test_f32c_layout_is_the_stencil_of_the_rounded_taps(precision, cplx, fd):
    """'f32c', the plan's form for real cubic traces: the float32 stencil
    entries of the rounded taps, bit for bit; for 'i8x4' each times s_m /
    127 of its transmit (a float32 product), the scale folded into the
    layout. At 'bf16pair' and 'bf16' that is the float32 layout of the
    rounded traces, so the float32 term on it is das_sum(round_taps(x))."""
    x = _traces(19, 3, 5, fd, cplx, 7)
    s = das_cuda.i8_scale(x) if precision == "i8x4" else None
    xq = das_cuda.round_taps(x, precision, s)
    got = das_cuda.trace_layout_plain(x, "cubic", precision, s, "f32c")
    want = _stencils(xq, "cubic")
    if precision == "i8x4":
        want = want * das_cuda.dequant(s).reshape((-1,) + (1,) * (want.ndim - 1))
    else:
        assert torch.equal(got, das_cuda.trace_layout_plain(xq, "cubic"))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert got.shape == (5, 3, 19) + fd + ((2,) if cplx else ()) + (4,)


@pytest.mark.parametrize("fd", [(), (3,)], ids=["one_frame", "frames"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_h16_layout_holds_the_int8_taps_coefficients(cplx, fd):
    """'h16' (i8x4, cubic): the stencil entries of the int8 taps as IEEE
    half-precision bits, each equal to its float32 value (exact), and
    times s_m / 127 the 'f32c' layout of the same traces."""
    x = _traces(23, 4, 3, fd, cplx, 8)
    s = das_cuda.i8_scale(x)
    q = das_cuda.round_taps(x, "i8x4", s)
    got = das_cuda.trace_layout_plain(x, "cubic", "i8x4", s, "h16")
    assert got.dtype == torch.int16
    want = _stencils(q, "cubic")
    assert torch.equal(got.view(torch.float16).float(), want)
    assert torch.equal(got, want.to(torch.float16).view(torch.int16))
    f32c = das_cuda.trace_layout_plain(x, "cubic", "i8x4", s, "f32c")
    dq = das_cuda.dequant(s).reshape((-1,) + (1,) * (want.ndim - 1))
    assert torch.equal(got.view(torch.float16).float() * dq, f32c)


@pytest.mark.parametrize("precision", ["bf16pair", "bf16", "i8x4"])
def test_taps_forms_stay_the_rounded_taps(precision):
    """The rounded taps' forms ('bf16', 'i8': the default form) hold the
    taps' bits, as before the coefficient forms: for every sampler the
    precision takes, real and complex, with frames."""
    for cplx in (False, True):
        x = _traces(11, 2, 3, (2,), cplx, 9)
        s = das_cuda.i8_scale(x) if precision == "i8x4" else None
        xq = das_cuda.round_taps(x, precision, s)
        xr = torch.view_as_real(xq) if cplx else xq[..., None]
        k = torch.arange(11)
        for method in PREC_METHODS[precision]:
            lay = das_cuda.trace_layout_plain(x, method, precision, s)
            form = das_cuda.taps_form(precision)
            assert torch.equal(lay, das_cuda.trace_layout_plain(x, method, precision, s, form))
            js = {"nearest": (0,), "linear": (0, 1)}.get(method, (-1, 0, 1, 2))
            taps = torch.stack([xr[torch.clamp(k + j, 0, 10)] for j in js], -1)
            taps = taps.permute(2, 1, 0, *range(3, taps.ndim))
            taps = taps if cplx else taps[..., 0, :]
            if method == "nearest":
                taps = taps[..., 0]
            wide = lay.float() if precision == "i8x4" else \
                lay.view(torch.bfloat16).float()
            assert torch.equal(wide, taps), (method, cplx)


def test_h16_coefficients_of_int8_taps_are_exact():
    """Every Catmull-Rom coefficient of four int8 taps in [-127, 127], as
    the layout forms it in float32, is a multiple of 1/2 with |c0|, |c1|
    <= 127, |c2| <= 762, |c3| <= 508, so half precision (11 significant
    bits) holds it exactly: every corner quadruple of (-127, 0, 127) and
    10^5 random ones, against the exact rational value in float64."""
    corners = np.array(np.meshgrid(*[[-127, 0, 127]] * 4, indexing="ij")).reshape(4, -1).T
    rng = np.random.default_rng(19)
    rand = rng.integers(-127, 128, size=(100_000, 4))
    q = torch.as_tensor(np.concatenate([corners, rand]).astype(np.float32))
    c = torch.stack(das_cuda.stencil_entry(q.unbind(-1), "cubic"), -1)
    a, b, cc, d = (q.double()[:, j] for j in range(4))
    exact = torch.stack([b, (cc - a) / 2, a - 2.5 * b + 2 * cc - d / 2,
                         1.5 * (b - cc) + (d - a) / 2], -1)
    assert torch.equal(c.double(), exact)
    assert torch.equal(c.to(torch.float16).float(), c)
    assert torch.equal((2 * c).round(), 2 * c)
    lim = torch.tensor([127.0, 127.0, 762.0, 508.0])
    assert bool((c.abs() <= lim).all())
    assert torch.equal(c[:81].abs().amax(0), lim)  # the corners reach each bound


# -------------------------------------------- the image from each form
def _read(lay, form, method, ti, m, dq):
    """The samples a kernel reads from transmit m's entries of layout
    ``lay`` (M, N, T, [2,] E) at delays ``ti`` (I, N), 0 at an invalid
    delay: the coefficient forms' cubic c0 + u (c1 + u (c2 + u c3)) (h16
    times s_m / 127), the taps forms' sampler weights dot the taps (i8
    times s_m / 127)."""
    T = lay.shape[2]
    valid = (ti >= 0) & (ti <= T - 1)
    t = torch.where(valid, ti, torch.zeros_like(ti))
    k = torch.floor(t)
    u = (t - k)[..., None]
    n = torch.arange(ti.shape[1])[None, :].expand_as(k)
    e = lay[m][n, k.long()]  # (I, N, [2,] E)
    cplx = e.ndim == 4
    if cplx:
        u = u[..., None]
    if form in ("f32c", "h16"):
        c = e.view(torch.float16).float() if form == "h16" else e
        v = c[..., 0] + u[..., 0] * (c[..., 1] + u[..., 0] * (c[..., 2] + u[..., 0] * c[..., 3]))
    else:
        taps = e.float() if form == "i8" else e.view(torch.bfloat16).float()
        uu = u[..., 0]
        if method == "cubic":
            w = [0.5 * (uu * (-1.0 + uu * (2.0 - uu))), 0.5 * (2.0 + uu * uu * (-5.0 + 3.0 * uu)),
                 0.5 * (uu * (1.0 + uu * (4.0 - 3.0 * uu))), 0.5 * (uu * uu * (uu - 1.0))]
        else:
            w = [_lanczos_w(uu + 1), _lanczos_w(uu), _lanczos_w(uu - 1), _lanczos_w(uu - 2)]
        v = sum(w[j] * taps[..., j] for j in range(4))
    if form in ("h16", "i8"):
        v = v * dq[m]
    v = torch.where(valid[..., None] if cplx else valid, v, torch.zeros_like(v))
    return torch.complex(v[..., 0], v[..., 1]) if cplx else v


def _image(x, precision, method, ti_of, lut):
    """The summed image a kernel computes from the plan's layout of ``x``
    (T, N, M): every term's sample read from its entries (:func:`_read`)."""
    cplx = x.is_complex()
    s = das_cuda.i8_scale(x, per_transmit=not lut) if precision == "i8x4" else None
    form = das_cuda.entry_form(method, precision, cplx)
    lay = das_cuda.trace_layout_plain(x, method, precision, s, form)
    dq = das_cuda.dequant(s) if s is not None else None
    return sum(_read(lay, form, method, ti_of(m), m, dq).sum(1) for m in range(x.shape[2]))


LAYOUT_CASES = [(kern, p, m, c) for kern in ("K1", "K2") for p in ("bf16pair", "i8x4")
                for m in ("cubic", "lanczos3") for c in (False, True)
                if kern == "K1" or m == "cubic"]


@pytest.mark.parametrize("kern,precision,method,cplx", LAYOUT_CASES,
                         ids=[f"{k}-{p}-{m}-{'complex' if c else 'real'}"
                              for k, p, m, c in LAYOUT_CASES])
def test_image_from_the_plan_layout_matches_pallas_interpret(kern, precision, method, cplx):
    """K1(e) and K2(e)'s arithmetic on the plan's layout (the float32
    coefficients of the rounded taps for real cubic traces, the int8
    taps' half-precision coefficients for complex cubic 'i8x4', else the
    rounded taps) against the TPU kernel in interpret mode
    (das_tiled / das_lut_tiled) on one 16 x 4 chunk: within 1e-4 of the
    peak (lanczos3: 1e-3, the TPU kernel's folded window's own limit)."""
    x, pi, pr, pv, nv, t0 = problem(cplx=cplx)
    xt = torch.as_tensor(x)
    fs = np.float32(FS)
    if kern == "K1":
        pit, prt, pvt, nvt = (torch.as_tensor(a) for a in (pi, pr, pv, nv))
        dr = rx_distance(pit, prt)

        def ti_of(m):
            dv = tx_distance(pit, pvt[m], nvt[m], "plane")
            return (torch.as_tensor(CINV) * (dv[:, None] + dr) - torch.as_tensor(t0[m])) * \
                float(fs)

        ref = das_tiled(x, pi, pr, pv, nv, t0, CINV, fs=FS, tx_model="plane", method=method,
                        im_shape=(16, 128, 1), interpret=True, precision=precision)
    else:
        tau_rx, tau_tx = tables(pi, pr, nv, t0)
        trx, ttx = torch.as_tensor(tau_rx), torch.as_tensor(tau_tx)

        def ti_of(m):
            return ((ttx[:, m, None] + trx) - torch.as_tensor(t0[m])) * float(fs)

        ref = das_lut_tiled(x, tau_rx, tau_tx, t0, fs=FS, method=method, im_shape=(16, 128, 1),
                            interpret=True, precision=precision)
    got = _image(xt, precision, method, ti_of, kern == "K2").numpy()
    ref = np.asarray(ref).reshape(got.shape)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err < TOL_METHOD.get(method, TOL), err
    # and the plain version (the same rounded taps, no layout) agrees
    kw = dict(fs=FS, method=method, precision=precision)
    if kern == "K1":
        plain = das_cuda.das_sum(xt, pi, pr, pv, nv, t0, CINV, tx_model="plane", **kw)
    else:
        plain = das_cuda.das_lut_sum(xt, tau_rx, tau_tx, t0, **kw)
    plain = plain.reshape(got.shape).numpy()
    assert np.abs(got - plain).max() < TOL * np.abs(plain).max()


# -------------------------------------------------------- the plan
def _cu_reads(src, q, method, cplx, keep):
    """das.cu's reads(q, method, cplx, keep), evaluated from its source: a
    chain ``c1 ? v1 : c2 ? v2 : ... : v``, each condition and value a C
    expression of q, method, cplx, keep and the enums."""
    body = re.search(r"constexpr bool reads\(int q, int method, bool cplx, bool keep\) \{\s*"
                     r"return (.*?);\s*\}", src, re.S).group(1)
    enums = {"NEAREST": 0, "LINEAR": 1, "CUBIC": 2, "LANCZOS3": 3, "F32": 0, "BF16": 1, "I8": 2,
             "F32X": 3, "H16": 4, "true": True, "false": False}
    env = dict(enums, q=q, method=METHODS.index(method), cplx=bool(cplx), keep=bool(keep))

    def ev(e):
        e = re.sub(r"!(?!=)", " not ", e.replace("&&", " and ").replace("||", " or "))
        e = " ".join(e.split())
        return bool(eval(e, {"__builtins__": {}}, env))  # noqa: S307 (das.cu's own text)

    *arms, last = body.split(":")
    for arm in arms:
        cond, val = arm.split("?")
        if ev(cond):
            return ev(val)
    return ev(last)


@pytest.mark.parametrize("keep", [False, True], ids=["summed", "keep"])
@pytest.mark.parametrize("F", [1, 4], ids=["one_frame", "four_frames"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("method,precision", [
    (m, p) for p in ("f32", "bf16pair", "bf16", "i8x4") for m in METHODS
    if p != "i8x4" or m in ("cubic", "lanczos3")])
def test_entry_form_plan_mirrors_the_kernel(method, precision, cplx, F, keep):
    """entry_form's plan: cubic 'i8x4' traces take the int8 taps'
    coefficients in half precision, but real ones in the keep kernel the
    float32 coefficients of the rounded taps, as real cubic bf16 traces
    do; the rest the rounded taps, whatever the frames; das.cu's
    reads(q, method, cplx, keep) builds the variants of the plan's entry
    type and no narrow variant the plan does not launch; frames_per_launch
    follows the summed plan's entry type."""
    src = DAS_CU.read_text()
    form = das_cuda.entry_form(method, precision, cplx, keep)
    want = ("f32" if precision == "f32" else das_cuda.taps_form(precision)
            if method != "cubic" else "h16" if precision == "i8x4" and (cplx or not keep)
            else "f32c" if not cplx else das_cuda.taps_form(precision))
    assert form == want
    q = das_cuda.FORMS[form]
    assert _cu_reads(src, q, method, cplx, keep)
    for other in (1, 2, das_cuda.H16):  # the narrow entry types: the plan's alone
        if other != q:
            planned = any(das_cuda.FORMS[das_cuda.entry_form(method, p, cplx, keep)] == other
                          for p in PREC_METHODS if method in PREC_METHODS[p])
            assert _cu_reads(src, other, method, cplx, keep) == planned, other
    x = torch.zeros((8, 2, 3, F), dtype=torch.complex64 if cplx else torch.float32)
    assert das_cuda.tx_chunks(x, method, precision) == das_cuda.tx_chunks(
        x, method, precision, das_cuda.entry_form(method, precision, cplx))
    q = das_cuda.FORMS[das_cuda.entry_form(method, precision, cplx)]
    fb = das_cuda.frames_per_launch(method, precision, cplx)
    assert fb == (1 if method == "cubic" and q == 0 and cplx else das_cuda.FRAMES_A_LAUNCH)


def test_forms_the_layout_kernel_refuses():
    """A form no layout kernel writes raises ValueError: coefficients of a
    sampler other than cubic, 'h16' of bf16 taps, 'f32c' at 'f32', an
    unknown form."""
    x = _traces(8, 2, 2, (), False, 3)
    s = das_cuda.i8_scale(x)
    for method, precision, form, sc in (("lanczos3", "i8x4", "f32c", s),
                                        ("linear", "bf16pair", "f32c", None),
                                        ("cubic", "bf16pair", "h16", None),
                                        ("cubic", "f32", "f32c", None),
                                        ("cubic", "bf16pair", "i8", None),
                                        ("cubic", "bf16pair", "f16", None)):
        with pytest.raises(ValueError, match="no '"):
            das_cuda.trace_layout_plain(x, method, precision, sc, form)


# -------------------------------------- the card path, with a recorder
class _Lib:
    """A stand-in for a kernel library's entry point: records each call's
    library, its trailing arguments and returns success."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def __call__(self, *a):
        self.log.append((self.name, a))
        return 0


@pytest.fixture
def card_path(monkeypatch):
    """das_sum and das_lut_sum take CPU tensors down the card path, every
    library replaced by a recorder: [(library, arguments)]."""
    log = []
    monkeypatch.setattr(das_cuda, "is_cuda", lambda t: True)
    monkeypatch.setattr(_nvcc, "stream_args", lambda dev: (0, 0))
    monkeypatch.setattr(das_cuda, "build", lambda iq=False, wide=False: (_Lib("das", log), ""))
    monkeypatch.setattr(das_cuda, "build_lut", lambda iq=False, wide=False: _Lib("das", log))
    monkeypatch.setattr(das_cuda, "build_q",
                        lambda q, iq=False, wide=False: (_Lib(f"q{q}", log), ""))
    monkeypatch.setattr(das_cuda, "build_lut_q",
                        lambda q, iq=False, wide=False: _Lib(f"q{q}", log))
    monkeypatch.setattr(das_cuda, "build_keep",
                        lambda iq=False, wide=False: (_Lib("das_keep", log), ""))
    monkeypatch.setattr(das_cuda, "build_keep_q",
                        lambda q, iq=False, wide=False: (_Lib(f"keep_q{q}", log), ""))
    monkeypatch.setattr(das_cuda, "build_layout", lambda: _Lib("layout", log))
    monkeypatch.setattr(das_cuda, "build_layout_q", lambda q: _Lib(f"layout_q{q}", log))
    return log


# (precision, sampler, complex, the summed calls' form, the keep kernel's)
FORM_CASES = [("bf16pair", "cubic", False, "f32c", "f32c"),
              ("bf16", "cubic", False, "f32c", "f32c"),
              ("i8x4", "cubic", False, "h16", "f32c"), ("i8x4", "cubic", True, "h16", "h16"),
              ("bf16pair", "cubic", True, "bf16", "bf16"),
              ("i8x4", "lanczos3", False, "i8", "i8"),
              ("bf16pair", "linear", False, "bf16", "bf16"),
              ("f32", "cubic", False, "f32", "f32")]


@pytest.mark.parametrize("lut", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("precision,method,cplx,summed,kept", FORM_CASES,
                         ids=[f"{p}-{m}-{'complex' if c else 'real'}" for p, m, c, _, _ in
                              FORM_CASES])
def test_launches_per_form(card_path, precision, method, cplx, summed, kept, lut):
    """The card path of each form: the layout kernel of the precision's
    unit writing the plan's form (das_layout_q's form argument: 0 for
    float32 coefficients), then the kernels of the form's entry type (the
    float32 units for 'f32c', with no scale argument: it is in the
    layout; the int8 unit with prec 4 and s_m / 127 for 'h16'), each
    launch counted in PREC_LAUNCHES / LUT_PREC_LAUNCHES (LAUNCHES /
    LUT_LAUNCHES at 'f32') and in no other counter; summed and keep_rx."""
    x = _traces(16, 4, 3, (), cplx, 4)
    pi = torch.zeros((5, 3))
    pr, pv, nv = torch.zeros((4, 3)), torch.zeros((3, 3)), torch.zeros((3, 3))
    tau = torch.zeros((5, 4)), torch.zeros((5, 3))
    for keep in (False, True):
        form = kept if keep else summed
        assert das_cuda.entry_form(method, precision, cplx, keep) == form
        q = das_cuda.FORMS[form]
        counts = lambda: (das_cuda.PREC_LAUNCHES, das_cuda.LUT_PREC_LAUNCHES,  # noqa: E731
                          das_cuda.LAUNCHES, das_cuda.LUT_LAUNCHES, das_cuda.KEEP_LAUNCHES,
                          das_cuda.LUT_KEEP_LAUNCHES, das_cuda.APOD_LAUNCHES)
        before = counts()
        card_path.clear()
        kw = dict(fs=FS, method=method, precision=precision, keep_rx=keep)
        if lut:
            if precision == "bf16":
                continue
            das_cuda.das_lut_sum(x, *tau, np.zeros(3, np.float32), **kw)
        else:
            das_cuda.das_sum(x, pi, pr, pv, nv, np.zeros(3, np.float32), CINV,
                             tx_model="plane", **kw)
        (lay, la), (lib, ka) = card_path
        if precision == "f32":
            assert lay == "layout"
        else:
            assert lay == f"layout_q{das_cuda._ENTRY[precision]}"
            assert la[-3] == q  # the form written
        want = ("das_keep" if keep else "das") if q == 0 else \
            (f"keep_q{q}" if keep else f"q{q}")
        assert lib == want
        if q:
            lp = ka[-5:-2] if keep else ka[-4:-2]
            assert lp[0] == q and (lp[1] is not None) == (q in (2, das_cuda.H16))
        delta = np.subtract(counts(), before)
        which = (1 if lut else 0) if precision != "f32" else \
            ((5 if lut else 4) if keep else (3 if lut else 2))
        assert delta[which] == 1 and delta.sum() == 1, (delta, which)
