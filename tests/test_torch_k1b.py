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

from qups_tpu_torch.ops import das_cuda  # noqa: E402
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
    launch, the keep kernel's (KEEP_FRAMES) and PHASE_MAX."""
    src = DAS_CU.read_text()
    assert _cu_int(src, "FRAMES_A_LAUNCH") == das_cuda.FRAMES_A_LAUNCH
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


@pytest.mark.parametrize("F", [1, 3, 4, 6, 9])
@pytest.mark.parametrize("method", METHODS)
def test_launch_frames_follows_the_plan(method, F, monkeypatch):
    """K1's and K2's launches: one per chunk of transmits and block of at
    most frames_per_launch(method) frames, the blocks in order and whole
    but the last, each on the chunk's layout with the frames outside the
    time axis; w = float32(2 pi fmod), add after the first chunk."""
    x = torch.as_tensor(np.random.default_rng(F).standard_normal((5, 2, 3, F)),
                        dtype=torch.float32)
    full = das_cuda.LAYOUT_BYTES
    for fb_max in (das_cuda.frames_per_launch(method), 2):
        for budget in (full, 1):  # one chunk; a chunk a transmit
            monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", budget)
            calls = []
            das_cuda._launch_frames(x, method, 5e6, lambda *a: calls.append(a), fb_max)
            chunks = das_cuda.tx_chunks(x, method)
            blocks = [(f0, min(fb_max, F - f0)) for f0 in range(0, F, fb_max)]
            assert [(c[1], c[2]) for c in calls] == [c for c in chunks for _ in blocks]
            assert [(c[4], c[5]) for c in calls] == blocks * len(chunks)
            assert all(c[3] == F and c[6] == das_cuda._w(5e6) for c in calls)
            assert [c[7] for c in calls] == [int(j > 0) for j in range(len(chunks))
                                              for _ in blocks]
            for c in calls:
                want = das_cuda.trace_layout_plain(x[:, :, c[1]:c[2]], method)
                assert torch.equal(c[0], want)


@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "chunk_a_transmit"])
def test_one_frame_a_launch_runs_one_frame_calls(chunked, monkeypatch):
    """Where the plan takes one frame a launch (complex cubic float32
    traces), K1 and K2 run each frame as a one-frame call: its traces
    copied whole, laid out by chunks (F = 1, f0 = 0, fb = 1; add after the
    first chunk) and summed into its own row, which fills frame f of the
    (I, F) output."""
    assert das_cuda.frames_per_launch("cubic", "f32", cplx=True) == 1
    if chunked:
        monkeypatch.setattr(das_cuda, "LAYOUT_BYTES", 1)
    rng = np.random.default_rng(5)
    x = torch.as_tensor((rng.standard_normal((6, 2, 3, 2, 2))
                         + 1j * rng.standard_normal((6, 2, 3, 2, 2))).astype(np.complex64))
    out = torch.full((5, 4), np.nan, dtype=torch.complex64)
    calls = []

    def launch(xl, m0, m1, F, f0, fb, w, add, o):
        calls.append((m0, m1, F, f0, fb, add))
        v = torch.view_as_complex(xl.reshape(-1, 2)).sum() if xl.dtype != torch.complex64 \
            else xl.sum()
        o.copy_(o + v if add else v.expand(o.shape))

    das_cuda._launch_frames(x, "cubic", 5e6, launch, 1, out=out)
    xF = x.reshape(6, 2, 3, 4)
    chunks = das_cuda.tx_chunks(xF[..., :1], "cubic")
    assert calls == [(m0, m1, 1, 0, 1, int(j > 0)) for _ in range(4)
                     for j, (m0, m1) in enumerate(chunks)]
    assert len(chunks) == (3 if chunked else 1)
    for f in range(4):
        want = sum(torch.view_as_complex(das_cuda.trace_layout_plain(
            xF[:, :, m0:m1, f], "cubic").reshape(-1, 2)).sum() for m0, m1 in chunks)
        assert torch.allclose(out[:, f], want.expand(5))
