"""K1(b) and K2(b)'s plan on the CPU: the wrapper's choice of rotation
(the short rotation within PHASE_MAX, sincosf past it), its copy of
csrc/das.cu's frames a launch, and the blocks of frames the wrapper
launches. The kernels themselves run in tests/test_torch_cuda.py; the
frames and fmod paths' values are held to the JAX package in
test_torch_das.py and test_torch_das_lut.py."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qups_tpu_torch.ops import _nvcc, das_cuda  # noqa: E402
from qups_tpu_torch.ops.interp import METHODS  # noqa: E402

DAS_CU = Path(das_cuda.__file__).resolve().parents[1] / "csrc" / "das.cu"


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


def _cu_frames_a_launch(src, method, q, cplx):
    """das.cu's frames_a_launch(method, q, cplx), evaluated from its source:
    ``return <terms joined by &&> ? <n> : FRAMES_A_LAUNCH;``, each term
    ``method == <Method>``, ``q == <Prec>`` or ``cplx``."""
    body = re.search(r"constexpr int frames_a_launch\(int method, int q, int cplx\) \{\s*"
                     r"return (.*?) \? (\d+) : FRAMES_A_LAUNCH;\s*\}", src, re.S)
    enums = {"NEAREST": 0, "LINEAR": 1, "CUBIC": 2, "LANCZOS3": 3, "F32": 0, "BF16": 1, "I8": 2}
    env = {"method": METHODS.index(method), "q": q, "cplx": int(cplx)}
    hit = True
    for term in body.group(1).split("&&"):
        term = term.strip()
        if "==" in term:
            name, value = (t.strip() for t in term.split("=="))
            hit &= env[name] == enums[value]
        else:
            hit &= bool(env[term])
    return int(body.group(2)) if hit else _cu_int(src, "FRAMES_A_LAUNCH")


def test_frame_constants_mirror_the_kernel():
    """The wrapper's copies of das.cu's constants: K1(b)/K2(b)'s frames a
    launch and the span of a block of entries that sets K1's
    (FRAME_SPAN), the keep kernel's frames a launch (KEEP_FRAMES) and
    PHASE_MAX."""
    src = DAS_CU.read_text()
    assert _cu_int(src, "FRAMES_A_LAUNCH") == das_cuda.FRAMES_A_LAUNCH
    assert _cu_int(src, "FRAME_SPAN") == das_cuda.FRAME_SPAN
    assert _cu_int(src, "KEEP_FRAMES") == das_cuda.KEEP_FRAMES
    pmax = float.fromhex(re.search(r"constexpr float PHASE_MAX = (0x[0-9a-fp]+)f;",
                                   src).group(1))
    assert pmax == das_cuda.PHASE_MAX


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("method,precision", [
    (m, p) for p in ("f32", "bf16pair", "i8x4") for m in METHODS
    if p != "i8x4" or m in ("cubic", "lanczos3")])
def test_frame_plan_mirrors_the_kernel(method, precision, cplx):
    """frames_per_launch(method, precision, cplx) is das.cu's
    frames_a_launch for the entry type of ``precision``: one frame a
    launch for complex cubic float32 traces, FRAMES_A_LAUNCH (4) for every
    other; 'bf16' shares 'bf16pair''s entry type."""
    src = DAS_CU.read_text()
    want = _cu_frames_a_launch(src, method, das_cuda._ENTRY[precision], cplx)
    assert das_cuda.frames_per_launch(method, precision, cplx) == want
    assert want == (1 if (method, precision, cplx) == ("cubic", "f32", True) else 4)
    if precision == "bf16pair":
        assert das_cuda.frames_per_launch(method, "bf16", cplx) == want


def test_rotation_follows_the_phase_range():
    """The wrapper's rotation: none without fmod; the short rotation while
    |w| (T - 1) / fs (w = float32(2 pi fmod)), with a 2^-20 margin, lies
    within PHASE_MAX (the IQ headline's 4114 rad, RF at 31.25 MHz), sincosf
    past it, at fs = 0 (every delay valid) and at the boundary's far side;
    the sign of fmod and fs does not matter."""
    w = das_cuda._w
    assert das_cuda.rotation(0.0, 1024, 7.8125e6) == "none"
    assert das_cuda.rotation(5e6, 1024, 7.8125e6) == "reduced"
    assert abs(w(5e6) * 1023 / 7.8125e6 - 4114.0) < 1.0
    assert das_cuda.rotation(5e6, 4096, 31.25e6) == "reduced"
    assert das_cuda.rotation(-5e6, 1024, -7.8125e6) == "reduced"
    assert das_cuda.rotation(4e9, 2048, 2e7) == "sincosf"
    assert das_cuda.rotation(5e6, 1024, 0.0) == "sincosf"
    fs = 7.8125e6
    # the longest trace at fmod 5 MHz that keeps the short rotation
    T = int(das_cuda.PHASE_MAX / (1 + 2.0 ** -20) * fs / w(5e6)) + 1
    assert das_cuda.rotation(5e6, T, fs) == "reduced"
    assert das_cuda.rotation(5e6, T + 1, fs) == "sincosf"
    rng = np.random.default_rng(17)
    for _ in range(200):
        fmod, fs, T = rng.uniform(-1e9, 1e9), rng.uniform(1e5, 1e8), int(rng.integers(1, 1 << 22))
        wf, fsf = float(np.float32(2 * np.pi * fmod)), float(np.float32(fs))
        want = abs(wf) * (T - 1) / fsf * (1 + 2.0 ** -20) <= das_cuda.PHASE_MAX
        assert das_cuda.reduced_rotation(wf, T, fs) == want
        assert das_cuda.rotation(fmod, T, fs) == ("reduced" if want else "sincosf")


def _blocks(F, fb):
    return [(b0, min(b0 + fb, F)) for b0 in range(0, F, fb)]


@pytest.mark.parametrize("F", [1, 3, 4, 6, 9])
@pytest.mark.parametrize("method", METHODS)
def test_launch_frames_follows_the_plan(method, F, monkeypatch):
    """K1's and K2's launches: the layout in blocks of the launch's frames
    (or of ``block`` frames: the whole ensemble, the layout before blocks),
    one group of whole blocks and one chunk of transmits while the layout
    fits its budget, else a group a block and a chunk a transmit; one
    launch per run of at most fb_max frames of each block of each chunk,
    in order, each handed its block from its first frame on (the block's
    own offset) and the block's frames a tap base (its stride); w =
    float32(2 pi fmod), add after the block's first chunk."""
    x = torch.as_tensor(np.random.default_rng(F).standard_normal((5, 2, 3, F)),
                        dtype=torch.float32)
    full = das_cuda.LAYOUT_BYTES
    for fb_max, block in ((das_cuda.frames_per_launch(method), None), (2, None), (2, F),
                          (1, F)):
        blocks = _blocks(F, block or fb_max)
        for budget, groups, chunks in ((full, [(0, F)], [(0, 3)]),
                                       (1, blocks, [(0, 1), (1, 2), (2, 3)])):
            monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", budget)
            assert das_cuda.layout_chunks(x, method, block or fb_max) == [
                (g0, g1, chunks) for g0, g1 in groups]
            calls = []
            das_cuda._launch_frames(x, method, 5e6, lambda *a: calls.append(a), fb_max,
                                    block=block)
            want = [(m0, m1, F, f0, min(fb_max, b1 - f0), b1 - b0, das_cuda._w(5e6), int(j > 0))
                    for g0, g1 in groups for j, (m0, m1) in enumerate(chunks)
                    for b0, b1 in blocks if g0 <= b0 < g1 for f0 in range(b0, b1, fb_max)]
            assert [c[1:] for c in calls] == want
            for c, (m0, m1, _, f0, _, fl, _, _) in zip(calls, want):
                b0 = f0 - f0 % (block or fb_max)
                lay = das_cuda.trace_layout_plain(x[:, :, m0:m1, b0:b0 + fl], method)
                assert torch.equal(c[0], lay[:, :, :, f0 - b0:])


@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "chunk_a_transmit"])
def test_one_frame_a_launch_runs_one_frame_calls(chunked, monkeypatch):
    """Where the plan takes one frame a launch (complex cubic float32
    traces), K1 and K2 run each frame as a one-frame call (F = 1, f0 = 0,
    fb = 1; add after the first chunk of transmits) on its plane of one
    layout of all the chunk's frames in blocks of one (fl = 1: no copy of
    its traces), summed into its own row, which fills frame f of the (I,
    F) output."""
    assert das_cuda.frames_per_launch("cubic", "f32", cplx=True) == 1
    if chunked:
        monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", 1)
    rng = np.random.default_rng(5)
    x = torch.as_tensor((rng.standard_normal((6, 2, 3, 2, 2))
                         + 1j * rng.standard_normal((6, 2, 3, 2, 2))).astype(np.complex64))
    out = torch.full((5, 4), np.nan, dtype=torch.complex64)
    calls, laid = [], []
    real_blocks = das_cuda.layout_blocks

    def layout_blocks(*a, **k):
        laid.append(a[2:7])
        planes = real_blocks(*a, **k)
        laid[-1] += (planes,)
        return planes

    def launch(xl, m0, m1, F, f0, fb, fl, w, add, o):
        calls.append((xl, m0, m1, F, f0, fb, fl, add))
        v = torch.view_as_complex(xl.reshape(-1, 2)).sum()
        o.copy_(o + v if add else v.expand(o.shape))

    monkeypatch.setattr(das_cuda, "layout_blocks", layout_blocks)
    das_cuda._launch_frames(x, "cubic", 5e6, launch, 1, out=out)
    xF = x.reshape(6, 2, 3, 4)
    plan = das_cuda.layout_chunks(xF, "cubic", 1)
    assert plan == ([(f, f + 1, [(0, 1), (1, 2), (2, 3)]) for f in range(4)] if chunked
                    else [(0, 4, [(0, 3)])])
    assert [a[:5] for a in laid] == [(m0, m1, g0, g1, 1) for g0, g1, ch in plan
                                     for m0, m1 in ch]
    planes = [(m0, g0 + b, p) for m0, m1, g0, g1, _, ps in laid for b, p in enumerate(ps)]
    assert [c[1:] for c in calls] == [(m0, m1, 1, 0, 1, 1, int(j > 0)) for g0, g1, ch in plan
                                      for j, (m0, m1) in enumerate(ch) for _ in range(g0, g1)]
    assert all(c[0] is not p and c[0].data_ptr() == p.data_ptr() and c[0].shape[3] == 1
               for c, (_, _, p) in zip(calls, planes))
    for f in range(4):
        chunks = next(ch for g0, g1, ch in plan if g0 <= f < g1)
        want = sum(torch.view_as_complex(das_cuda.trace_layout_plain(
            xF[:, :, m0:m1, f], "cubic").reshape(-1, 2)).sum() for m0, m1 in chunks)
        assert torch.allclose(out[:, f], want.expand(5))


def _grid(half_width, nx, nz=4, z=(10e-3, 50e-3)):
    """(I, 3) pixels of a Cartesian scan in the system's order, x fastest:
    ``nx`` over x in +-half_width, ``nz`` rows."""
    Z, X = np.meshgrid(np.linspace(*z, nz), np.linspace(-half_width, half_width, nx),
                       indexing="ij")
    return np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)


# (cell, pixels' half width and count, fs, frames, sampler, precision,
# complex, sigma, frames a launch): the benchmark's four cells and the IQ
# headline (4 frames, T' 1024 at 7.8125 MHz)
STRIDE_CASES = [
    ("picmus-rf-ensemble", 18e-3, 512, 20.832e6, 16, "cubic", "f32", False, 1.907, 1),
    ("picmus-iq-ensemble", 18e-3, 512, 20.832e6, 16, "cubic", "f32", True, 1.907, 1),
    ("headline-rf-cubic", 12e-3, 1024, 31.25e6, 1, "cubic", "f32", False, 0.952, None),
    ("picmus-speckle-sim", 18e-3, 512, 20.832e6, 1, "cubic", "f32", True, 1.907, None),
    ("iq-headline", 12e-3, 1024, 7.8125e6, 4, "cubic", "f32", False, 0.238, 4),
    ("iq-headline", 12e-3, 1024, 7.8125e6, 4, "lanczos3", "f32", True, 0.238, 4),
    ("iq-headline", 12e-3, 1024, 7.8125e6, 4, "cubic", "f32", True, 0.238, 1),
    ("picmus-rf-ensemble", 18e-3, 512, 20.832e6, 16, "cubic", "i8x4", False, 1.907, 2),
    ("picmus-rf-ensemble", 18e-3, 512, 20.832e6, 16, "nearest", "f32", False, 1.907, 4),
    ("picmus-rf-ensemble", 18e-3, 512, 20.832e6, 16, "lanczos3", "f32", True, 1.907, 1),
]


@pytest.mark.parametrize("cell,hw,nx,fs,F,method,precision,cplx,sigma,fb", STRIDE_CASES,
                         ids=[f"{c[0]}-{c[5]}-{c[6]}-{'complex' if c[7] else 'real'}"
                              for c in STRIDE_CASES])
def test_frames_follow_the_tap_stride(cell, hw, nx, fs, F, method, precision, cplx, sigma,
                                      fb, monkeypatch):
    """K1's frames a launch from the tap stride of the call's host pixels:
    sigma = 2 cinv fs times the longest step among the first 32 pixels
    (PICMUS's 70.5 um at 20.832 MHz: 1.91, the headline's 23.5 um at 31.25
    MHz: 0.95, the IQ headline's at 7.8125 MHz: 0.24); the largest of 4,
    2, 1 within the cap whose entries at a tap base times sigma span at most
    FRAME_SPAN bytes (1.91 x 16-byte real cubic entries: 1 frame, 8-byte
    'h16' ones 2, 4-byte nearest ones 4); no decision without frames (no
    pixel read) nor for
    pixels on a device. Through das_sum's card path with recorders: F / fb
    launches, each at its block's offset in the one layout with fl = fb."""
    pi = _grid(hw, nx)
    cinv = np.float32(1 / 1540.0)
    got = das_cuda.tap_stride(pi, cinv, fs)
    assert abs(got - sigma) < 2e-3 * sigma
    assert das_cuda.tap_stride(torch.as_tensor(pi), cinv, fs) == got
    assert das_cuda.tap_stride(torch.as_tensor(pi, device="meta"), cinv, fs) is None
    cap = das_cuda.frames_per_launch(method, precision, cplx)
    assert das_cuda.frames_per_launch(method, precision, cplx, None) == cap
    if fb is not None:
        assert das_cuda.frames_per_launch(method, precision, cplx, got) == fb <= cap
    # das_sum on the card path, every library a recorder
    log = []
    monkeypatch.setattr(das_cuda, "is_cuda", lambda t: True)
    monkeypatch.setattr(_nvcc, "stream_args", lambda dev: (0, 0))
    rec = lambda name: lambda *a: log.append((name, a)) or 0  # noqa: E731
    monkeypatch.setattr(das_cuda, "build", lambda iq=False, wide=False: (rec("k1"), ""))
    monkeypatch.setattr(das_cuda, "build_q", lambda q, iq=False, wide=False: (rec("k1"), ""))
    monkeypatch.setattr(das_cuda, "build_layout", lambda: rec("layout"))
    monkeypatch.setattr(das_cuda, "build_layout_q", lambda q: rec("layout"))
    strides = []
    real_stride = das_cuda.tap_stride
    monkeypatch.setattr(das_cuda, "tap_stride", lambda *a: strides.append(a) or real_stride(*a))
    T, N, M = 12, 3, 2
    shape = (T, N, M, F)
    x = torch.zeros(shape, dtype=torch.complex64 if cplx else torch.float32)
    geo = (torch.zeros((N, 3)), torch.zeros((M, 3)), torch.zeros((M, 3)))
    das_cuda.das_sum(x, pi, *geo, np.zeros(M, np.float32), cinv, fs=fs, method=method,
                     precision=precision, tx_model="plane")
    assert len(strides) == (F > 1)
    (lay, la), *k1 = log
    assert lay == "layout" and la[6:9] == (F, F, fb or 1)  # F, the frames, the block
    form = das_cuda.entry_form(method, precision, cplx)
    plane = das_cuda.entry_bytes(method, form, cplx) * T * N * M
    if F == 1 or fb == 1:  # one-frame calls on each plane
        assert [(a[11], a[12], a[13], a[14]) for _, a in k1] == [(1, 0, 1, 1)] * F
    else:
        assert [(a[11], a[12], a[13], a[14]) for _, a in k1] == [
            (F, f0, fb, fb) for f0 in range(0, F, fb)]
    assert [a[0] - la[1] for _, a in k1] == [plane * f0 for f0 in range(0, F, fb or 1)]


@pytest.mark.parametrize("fb", [1, 2, 4])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("method,precision,form", [
    ("nearest", "f32", None), ("linear", "f32", None), ("cubic", "f32", None),
    ("lanczos3", "f32", None), ("cubic", "bf16pair", "f32c"), ("cubic", "i8x4", "h16"),
    ("nearest", "bf16pair", None)])
def test_layout_blocks_permute_the_frames_layout(method, precision, form, cplx, fb):
    """layout_blocks' plain version: frames g0:g1 of transmits m0:m1 in
    blocks of fb frames, the last short, each block trace_layout_plain of its
    frames; all of a call's frames in blocks hold the entries of the layout
    of every frame (trace_layout_plain), permuted: (F / fb, M, N, T, fb,
    entry) where fb divides F, block after block."""
    F, M = 6, 3
    rng = np.random.default_rng(fb)
    x = rng.standard_normal((9, 2, M, F)).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    x = torch.as_tensor(x)
    sc = das_cuda.i8_scale(x) if precision == "i8x4" else None
    whole = das_cuda.trace_layout_plain(x, method, precision, sc, form)  # (M, N, T, F, ...)
    blocks = das_cuda.layout_blocks(x, method, 0, M, 0, F, fb, precision, sc, form)
    assert [b.shape[3] for b in blocks] == [min(fb, F - b0) for b0 in range(0, F, fb)]
    for b0, b in zip(range(0, F, fb), blocks):
        assert torch.equal(b, whole[:, :, :, b0:b0 + fb])
    flat = torch.cat([b.reshape(-1) for b in blocks])
    if F % fb == 0:
        perm = whole.reshape(whole.shape[:3] + (F // fb, fb) + whole.shape[4:])
        assert torch.equal(flat, perm.movedim(3, 0).reshape(-1))
    real = lambda t: torch.view_as_real(t) if t.is_complex() else t  # noqa: E731
    assert torch.equal(real(flat).reshape(-1).sort().values,
                       real(whole).reshape(-1).sort().values)
    # a chunk of transmits and frames: frames 1:6 of transmits 1:3
    part = das_cuda.layout_blocks(x, method, 1, 3, 1, F, fb, precision, sc, form)
    for b0, b in zip(range(1, F, fb), part):
        assert torch.equal(b, das_cuda.trace_layout_plain(
            x[:, :, 1:3], method, precision, None if sc is None else sc[1:3],
            form)[:, :, :, b0:b0 + fb])


@pytest.mark.parametrize("t_inner", [False, True], ids=["contiguous", "time_innermost"])
def test_layout_blocks_read_one_chunk_of_strided_traces(t_inner, monkeypatch):
    """layout_blocks on the card path (its kernel a recorder): contiguous
    traces are read in place, the chunk's first transmit and frame at its
    offset in (T, N, M, F); traces whose time axis is innermost (as hilbert
    and downmix leave them) have only the chunk's transmits m0:m1 and
    frames g0:g1 gathered, once, and read from its start."""
    log = []
    monkeypatch.setattr(das_cuda, "is_cuda", lambda t: True)
    monkeypatch.setattr(_nvcc, "stream_args", lambda dev: (0, 0))
    monkeypatch.setattr(das_cuda, "build_layout",
                        lambda: lambda *a: log.append(a) or 0)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((7, 2, 5, 6)),
                        dtype=torch.float32)
    xs = x.permute(3, 2, 1, 0).contiguous().permute(3, 2, 1, 0) if t_inner else x
    copies = []
    real = torch.Tensor.contiguous
    monkeypatch.setattr(torch.Tensor, "contiguous",
                        lambda t, *a, **k: copies.append(tuple(t.shape)) or real(t, *a, **k))
    blocks = das_cuda.layout_blocks(xs, "cubic", 1, 4, 2, 6, 2)
    (a,) = log
    assert [b.shape[3] for b in blocks] == [2, 2]
    assert a[2:11] == ((7, 2, 3, 3, 4, 4, 2, 2, 0) if t_inner else (7, 2, 3, 5, 6, 4, 2, 2, 0))
    if t_inner:
        assert copies == [(7, 2, 3, 4)]
    else:
        assert copies == [] and a[0] == x.data_ptr() + (1 * 6 + 2) * 4
