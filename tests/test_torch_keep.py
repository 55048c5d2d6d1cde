"""The keep kernel's plan on the CPU (das_keep_kernel: K1(c), K1(d),
K2(c)): the wrapper's copies of csrc/das.cu's keep constants and frame
rule, the launches ``_das_keep`` makes (its kernel replaced by a recorder:
the entry by rotation, the frames, transmits and ``add`` of each launch),
and those launches composed of the plain versions, as the kernel combines
them (summed and keep_rx add a launch's sums to the stored ones, keep_tx
and both store their transmits'), held against the JAX package's ``das``
and ``das_lut``. The kernel itself runs in tests/test_torch_cuda.py."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu_torch as qt  # noqa: E402
from qups_tpu.ops.das import das as jax_das, das_lut as jax_das_lut  # noqa: E402
from qups_tpu_torch.ops import _nvcc, das_cuda  # noqa: E402
from qups_tpu_torch.ops.das import das, das_lut, delay_tables  # noqa: E402

DAS_CU = Path(das_cuda.__file__).resolve().parents[1] / "csrc" / "das.cu"
T, N, M, NX, NZ, FS, C0 = 96, 40, 6, 8, 6, 8e6, 1540.0
CINV = np.float32(1 / C0)
KEEPS = {"": (False, False), "rx": (True, False), "tx": (False, True), "both": (True, True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests (the suite runs several
    workers); restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cu_int(src, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))


def test_keep_constants_mirror_the_kernel():
    """The wrapper's copies of das.cu's keep constants: the sub-chunks of
    keep_rx's sums in registers (divisors of the receive table's chunk,
    multiples of its 4-receiver reads) and the frames a launch, one."""
    src = DAS_CU.read_text()
    assert _cu_int(src, "KEEP_NCK") == das_cuda.KEEP_NCK
    assert _cu_int(src, "KEEP_NCK_WIDE") == das_cuda.KEEP_NCK_WIDE
    assert _cu_int(src, "KEEP_FRAMES") == das_cuda.KEEP_FRAMES == 1
    for nck in (das_cuda.KEEP_NCK, das_cuda.KEEP_NCK_WIDE):
        assert das_cuda.NC % nck == 0 and nck % 4 == 0
    assert "KR_BYTES" not in src  # keep_rx's sums left shared memory


def _problem(seed, fd=(), cplx=False):
    """Traces (T, N, M, *fd) and a plane-wave geometry: NX x NZ pixels on
    x in +-4 mm, z in 6-14 mm, N receivers on x in +-6 mm, M plane waves
    in +-6 degrees, delays off both ends of the traces for some pixels."""
    rng = np.random.default_rng(seed)
    shape = (T, N, M) + fd
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    Z, X = np.meshgrid(np.linspace(6e-3, 14e-3, NZ), np.linspace(-4e-3, 4e-3, NX),
                       indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)
    pr = np.stack([np.linspace(-6e-3, 6e-3, N), np.zeros(N), np.zeros(N)], -1)
    th = np.radians(np.linspace(-6.0, 6.0, M))
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1)
    t0 = np.linspace(1e-6, 2e-6, M).astype(np.float32)
    return x, pi, pr.astype(np.float32), np.zeros((M, 3), np.float32), \
        nv.astype(np.float32), t0


def _weights(kind, pi, pr, nv, rng):
    """The port's apodization of one kind and its dense equivalent
    (I1, I2, I3, N, M) arrays (the JAX side's)."""
    im = (NZ, NX, 1)
    if kind == "none":
        return (), ()
    if kind == "fused":
        apod = (qt.Fused("aperture_growth", f=1.0), qt.Fused("tx_parallelogram",
                                                             xlo=-3e-3, xhi=5e-3))
    elif kind == "dense (I, N, 1)":
        apod = (rng.uniform(0, 1, im + (N, 1)).astype(np.float32),)
    else:
        apod = (rng.uniform(0, 1, (1, 1, 1, N, M)).astype(np.float32),
                rng.uniform(0.5, 1, (1, 1, 1, 1, M)).astype(np.float32))
    dense = das_cuda.dense_apod(apod, pi, pr, nv, im_shape=im, device="cpu")
    return apod, tuple(torch.as_tensor(a).numpy() for a in dense)


class _Recorder:
    """das_keep's stand-in: records each launch's frames, the layout's
    frames a tap base, transmits, add, keep mode, rotation flag and w;
    returns 0 (cudaSuccess)."""

    def __init__(self, t0):
        self.t0, self.calls = t0, []

    def __call__(self, *a):
        self.calls.append(dict(m0=(a[8] - self.t0.data_ptr()) // 4, M=a[12], F=a[14],
                               f0=a[15], fb=a[16], fl=a[17], w=a[20], src=a[21], rot=a[24],
                               add=a[25], keep=a[26], acc16=a[-3] if len(a) > 44 else None))
        return 0


def _recorded(monkeypatch, x, I, t0, **kw):
    """_das_keep's launches with its kernel recorded: (the units it bound,
    as (precision code, iq, wide), the launches)."""
    rec, bound = _Recorder(t0), []

    def bind(q):
        def build(iq=False, wide=False):
            bound.append((q, iq, wide))
            return rec, ""
        return build

    monkeypatch.setattr(das_cuda, "build_keep", bind(0))
    monkeypatch.setattr(das_cuda, "build_keep_q", lambda q, iq=False, wide=False:
                        bind(q)(iq, wide))
    monkeypatch.setattr(_nvcc, "stream_args", lambda dev: (0, 0))
    das_cuda._das_keep(x, I, t0, **kw)
    return bound, rec.calls


def _compose(calls, part, out_shape, keep_tx):
    """The launches' plain parts combined as the kernel combines them:
    keep_tx (and both) store a launch's transmits, summed and keep_rx add
    a launch's sums to the stored ones after the first chunk."""
    out = torch.zeros(out_shape, dtype=torch.complex64)
    for c in calls:
        ms, fs_ = slice(c["m0"], c["m0"] + c["M"]), slice(c["f0"], c["f0"] + c["fb"])
        v = part(ms, fs_)
        if keep_tx:
            assert c["add"] == 0
            out[:, :, ms, fs_] = v
        else:
            out[..., fs_] = out[..., fs_] + v if c["add"] else v
    return out


CASES = [(keep, w, src) for keep in sorted(KEEPS) for w in ("none", "fused", "dense (I, N, 1)",
                                                           "dense (1, N, M)")
         for src in ("plane", "tables") if (keep, w) != ("", "none")
         and not (src == "tables" and w == "fused")]


@pytest.mark.parametrize("keep,weights,src", CASES)
def test_keep_plan_of_plain_parts_matches_jax(keep, weights, src, monkeypatch):
    """_das_keep's launches (the layout budget cut to 4 transmits of every
    frame: with 5 frames two groups of frame planes, 2 and 3, of every
    transmit; without frames two chunks of transmits; fmod by turns)
    composed of the plain das / das_lut of each launch's transmits and
    frames, against the JAX package's das / das_lut on the whole problem
    with the same dense weights: within 1e-4 of the peak (2e-4 where the
    transmits are kept: its largest value is one term's, and XLA rounds the
    delays with fused multiply-adds, one ulp of delay moving a term by up to
    ~1e-4 of the largest; tests/test_torch_apod.py). Every (transmit,
    frame) in one launch, each launch one frame of a one-frame plane."""
    i = CASES.index((keep, weights, src))
    fd, cplx, fmod = [((), False, 0.0), ((5,), True, 2.5e6), ((5,), False, 0.0),
                      ((), True, 2.5e6)][i % 4]
    x, pi, pr, pv, nv, t0 = _problem(i, fd, cplx)
    rng = np.random.default_rng(100 + i)
    apod, dense = _weights(weights, pi, pr, nv, rng)
    keep_rx, keep_tx = KEEPS[keep]
    I, im = pi.shape[0], (NZ, NX, 1)
    xt, t0t = torch.as_tensor(x), torch.as_tensor(t0)
    kw = dict(fs=FS, method="cubic", fmod=fmod, apod=apod, keep_rx=keep_rx, keep_tx=keep_tx,
              im_shape=im)
    if src == "tables":
        tau_rx, tau_tx = delay_tables(pi, pr, pv, nv, C0, "plane", device="cpu")
        geo = dict(k2=(tau_rx, tau_tx))
    else:
        geo = dict(k1=tuple(torch.as_tensor(a) for a in (pi, pr, pv, nv)), cinv=CINV,
                   tx_model="plane")
    per_tx = 4 * 4 * T * N * (2 if cplx else 1) * int(np.prod(fd, dtype=np.int64))
    monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", 4 * per_tx)  # 4 transmits a chunk
    bound, calls = _recorded(monkeypatch, xt, I, t0t, **geo, **kw)
    assert bound == [(0, fmod != 0, False)]
    F = int(np.prod(fd, dtype=np.int64))
    assert [(c["m0"], c["f0"]) for c in calls] == (
        [(0, f) for f in range(F)] if F > 1 else [(0, 0), (3, 0)])
    assert all(c["fb"] == das_cuda.KEEP_FRAMES == c["fl"] and c["F"] == F
               and c["rot"] == int(fmod != 0) and c["keep"] == int(keep_rx) + 2 * int(keep_tx)
               for c in calls)
    assert sorted((c["m0"] + m, c["f0"] + f) for c in calls for m in range(c["M"])
                  for f in range(c["fb"])) == [(m, f) for m in range(M) for f in range(F)]
    xf = xt.reshape(T, N, M, F)

    def part(ms, fs_):
        sub = tuple(torch.as_tensor(a)[..., ms] if a.shape[4] != 1 else torch.as_tensor(a)
                    for a in dense)
        args = dict(fs=FS, method="cubic", fmod=fmod, apod=sub, keep_rx=keep_rx,
                    keep_tx=keep_tx, im_shape=im)
        if src == "tables":
            v = das_lut(xf[:, :, ms, fs_], tau_rx, tau_tx[:, ms], t0t[ms], **args)
        else:
            v = das(xf[:, :, ms, fs_], pi, pr, pv[ms], nv[ms], t0t[ms], CINV,
                    tx_model="plane", **args)
        return v.to(torch.complex64)

    shape = (I, N if keep_rx else 1, M if keep_tx else 1, F)
    got = _compose(calls, part, shape, keep_tx).reshape(shape[:3] + fd)
    jkw = dict(fs=FS, method="cubic", fmod=fmod, apod=dense, keep_rx=keep_rx, keep_tx=keep_tx,
               im_shape=im)
    if src == "tables":
        ref = np.asarray(jax_das_lut(x, tau_rx.numpy(), tau_tx.numpy(), t0, **jkw))
    else:
        ref = np.asarray(jax_das(x, pi, pr, pv, nv, t0, float(CINV), tx_model="plane", **jkw))
    got = got.numpy() if (cplx or fmod) else got.real.numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = 2e-4 if keep_tx else 1e-4
    assert np.abs(got - ref).max() < tol * np.abs(ref).max(), (keep, weights, src)


@pytest.mark.parametrize("precision,acc16,keep", [
    (p, a, k) for p, a in (("f32", False), ("f32", True), ("bf16pair", False), ("i8x4", False),
                           ("i8x4", True)) for k in sorted(KEEPS) if k or not a])
@pytest.mark.parametrize("fmod", [0.0, 2.5e6, 1e11], ids=["none", "reduced", "sincosf"])
def test_keep_entry_follows_rotation_and_precision(fmod, precision, acc16, keep, monkeypatch):
    """The unit and entry _das_keep binds: the keep unit of the call's entry
    form (real cubic traces: the float32 coefficients of the rounded taps,
    the float32 unit at every precision; acc16: the float32 unit with
    bfloat16 kept sums, a keep mode only),
    remodulating past fmod 0, by sincosf (the _iq_wide entries) where
    rotation() says the phases may pass PHASE_MAX; one launch a frame;
    acc16 passed to the unit."""
    x, pi, pr, pv, nv, t0 = _problem(7, (3,))
    xt, t0t = torch.as_tensor(x), torch.as_tensor(t0)
    k1 = tuple(torch.as_tensor(a) for a in (pi, pr, pv, nv))
    scale = das_cuda.i8_scale(xt) if precision == "i8x4" else None
    rot = das_cuda.rotation(fmod, T, FS)
    assert rot == ("none" if fmod == 0 else "sincosf" if fmod > 1e9 else "reduced")
    dense = (np.ones((1, 1, 1, N, 1), np.float32),)  # summed: a keep call has weights
    bound, calls = _recorded(monkeypatch, xt, pi.shape[0], t0t, fs=FS, method="cubic",
                             fmod=fmod, apod=() if keep else dense,
                             keep_rx=KEEPS[keep][0], keep_tx=KEEPS[keep][1], im_shape=None,
                             k1=k1, cinv=CINV, tx_model="plane", precision=precision,
                             scale=scale, acc16=acc16)
    # the keep kernel's entry form: real cubic traces take the float32
    # coefficients of the rounded taps at every precision, read by the
    # float32 units
    q = das_cuda.FORMS[das_cuda.entry_form("cubic", precision, False, keep=True)] or (
        das_cuda.F32X if acc16 else 0)
    assert q == (das_cuda.F32X if acc16 else 0)
    assert bound == [(q, fmod != 0, rot == "sincosf")]
    assert [(c["f0"], c["fb"]) for c in calls] == [(0, 1), (1, 1), (2, 1)]
    assert all(c["acc16"] == (int(acc16) if q else None) for c in calls)
