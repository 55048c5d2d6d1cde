"""The port's benchmark entry points, ``qups_tpu_torch.bench`` (the
headline) and ``qups_tpu_torch.benches`` (the ten sweeps), on the CPU.

Each bench's computation, at the sweeps' tiny sizes (``QUPS_BENCH_TINY``),
is given the same seeded numpy inputs as the JAX function on the CPU and
held to its output: das and coherence to ``ops.das`` (the JAX bench's CPU
call) and ``das_tiled`` in interpret mode (its accelerator call), linear;
lut to ``ops.das_lut``; greens to ``greens_freq`` and ``greens_splat``;
adjoint to ``bfAdjoint(kernel='pallas')`` in interpret mode (bf16, the JAX
bench's accelerator engine); focus, refocus and migration (op by op,
``jax.disable_jit``, as ``tests/test_torch_refocus.py``) to JAX's; fdtd to
JAX's stepper with kappa = 1 (``c_ref = 0``) and, at the bench's
``c_ref``, to the float64 k-Wave scheme of ``tests/test_torch_fdtd.py``
(JAX's 2-D stepper indexes kappa by the grid's columns, ROADMAP Queue 3);
eikonal to JAX's ``msfm``, bit for bit.

Tolerances, max|port - JAX| < tol * max|JAX|: 1e-4, the float32 standard;
2e-3 for bfAdjoint's bf16 operands (``tests/test_torch_fdbf.py``); the
steppers 2e-4 (``tests/test_torch_fdtd.py``).

Then ``main()`` of each module, stdout captured: every line parses as
JSON, its keys equal the JAX line's keys (read from the JAX files' source)
less the TPU-only keys the port's docstring names, no line holds
``error``, and an injected failure makes ``main()`` exit non-zero.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import bench as jbench  # noqa: E402
import qups_tpu as q  # noqa: E402
from qups_tpu.ops.coherence import cohfac, slsc  # noqa: E402
from qups_tpu.ops.das import das, das_lut, delay_tables  # noqa: E402
from qups_tpu.ops.eikonal import msfm  # noqa: E402
from qups_tpu.ops.fdbf import stolt_migration  # noqa: E402
from qups_tpu.ops.das_pallas import das_tiled  # noqa: E402
from qups_tpu.ops.greens import greens_splat  # noqa: E402
from qups_tpu.ops.greens_freq import greens_freq  # noqa: E402
from qups_tpu.sim import fdtd as jfdtd  # noqa: E402
from qups_tpu_torch import bench, benches  # noqa: E402
from qups_tpu_torch.sim import fdtd  # noqa: E402

from test_torch_fdtd import STEP_TOL, reference_stepper  # noqa: E402

F32 = 1e-4
ADJ = 2e-3
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: the suite runs six workers
    on the machine's cores. Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    for k in ("QUPS_BENCH_SIZE", "QUPS_BENCH_METHOD", "QUPS_BENCH_PRECISION",
              "QUPS_BENCH_MESH", "QUPS_BENCH_I8X4", "QUPS_BENCH_IMPL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("QUPS_BENCH_TINY", "1")
    return monkeypatch


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def traces(shape):
    """The sweeps' traces (seed 0), host numpy."""
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ the headline
@pytest.mark.parametrize("size", ["small", "medium"])
def test_das_problem_equals_the_root_bench(size):
    cfg = bench.CONFIGS[size]
    assert cfg == {"small": dict(T=1024, N=64, M=16, n=256),
                   "medium": dict(T=2048, N=128, M=64, n=512)}[size]
    for got, ref in zip(bench.das_problem(**cfg), jbench.das_problem(**cfg)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()
    assert bench.BASELINE_SUMS_PER_S == jbench.BASELINE_SUMS_PER_S
    assert "3.44e10" in bench.__doc__


def test_sweeps_draw_the_headline_problem():
    """The sweeps' traces and geometry at the headline's shape are the
    headline's (``chip_smoke.py`` phase 25 checks the lut and adjoint
    sweeps on the headline's traces), each transmit starting at 0."""
    cfg = bench.CONFIGS["small"]
    x, pi, pr, pv, nv, _ = bench.das_problem(**cfg)
    assert benches.traces(x.shape, CPU).numpy().tobytes() == x.tobytes()
    geo = benches.sweep_geometry(cfg["N"], cfg["M"])
    for got, ref in zip(geo, (pr, pv, nv)):
        assert got.tobytes() == ref.tobytes()
    assert not geo[3].any() and bench.pixels(cfg["n"]).tobytes() == pi.tobytes()


def test_headline_image_matches_jax():
    """The headline's call on a cut of the small problem (its first 16
    pixel rows) against JAX's ``das``, cubic and linear; and against the
    JAX kernel in interpret mode on a problem of one receiver and transmit
    chunk (16 x 4: interpret mode does not replay the kernel's accumulation
    across grid steps, ``tests/test_sweep.py:233-235``)."""
    for (T, N, M), methods, tiled in (((1024, 64, 16), ("cubic", "linear"), False),
                                      ((1024, 16, 4), ("cubic",), True)):
        x, pi, pr, pv, nv, t0 = jbench.das_problem(T=T, N=N, M=M, n=256)
        pi = pi[:16 * 256]
        for method in methods:
            kw = dict(fs=31.25e6, tx_model="plane", method=method)
            if tiled:
                ref = das_tiled(x, pi, pr, pv, nv, t0, 1.0 / 1540.0, im_shape=(16, 256, 1),
                                interpret=True, **kw)
            else:
                ref = das(x, pi, pr, pv, nv, t0, 1.0 / 1540.0, **kw)
            got = bench.das_sum(torch.as_tensor(x), pi, pr, pv, nv, t0, bench.CINV,
                                im_shape=(16, 256, 1), **kw)
            assert rel(got, ref) < F32, (N, M, method)


# --------------------------------------------------------------- the sweeps
def jax_das(x, pi, **kw):
    pr, pv, nv, t0 = benches.sweep_geometry(x.shape[1], x.shape[2])
    return das(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=31.25e6, tx_model="plane",
                    method="linear", **kw)


@pytest.mark.parametrize("n", [64, 128])
def test_das_sweep_matches_jax(n):
    x, pi = traces((256, 16, 4)), bench.pixels(n)
    got = benches.das_image(torch.as_tensor(x), pi, n)
    assert rel(got, jax_das(x, pi)) < F32
    if n == 64:
        pr, pv, nv, t0 = benches.sweep_geometry(16, 4)
        ref = das_tiled(x, pi, pr, pv, nv, t0, 1 / 1540.0, fs=31.25e6, tx_model="plane",
                        im_shape=(n, n, 1), interpret=True)
        assert rel(got, ref) < F32


@pytest.mark.parametrize("which", ["cohfac", "slsc"])
def test_coherence_sweep_matches_jax(which):
    """The keep_rx images within the float32 standard (against ``das`` and,
    on the first 16 rows, the kernel in interpret mode), the reduction of
    the same kept samples within coherence's 1e-5
    (``tests/test_torch_coherence.py``), and the bench's whole call within
    1e-3, the band of a ratio of roundings there (cohfac measured 1.01e-4
    on these white-noise traces)."""
    x, n = traces((512, 16, 4)), 128
    pi = bench.pixels(n)
    xt = torch.as_tensor(x)
    brx = np.asarray(jax_das(x, pi, keep_rx=True))[..., 0]
    assert rel(benches.das_image(xt, pi, n, keep_rx=True)[..., 0], brx) < F32
    post = {"cohfac": (benches.ops.cohfac, cohfac, {}),
            "slsc": (benches.ops.slsc, slsc, {"lags": 2})}[which]
    ref = post[1](brx, axis=1, **post[2])
    got = post[0](torch.as_tensor(brx), axis=1, **post[2])
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    assert rel(benches.coherence_image(xt, pi, n, which), ref) < 1e-3
    pr, pv, nv, t0 = benches.sweep_geometry(16, 4)
    sub = pi[:16 * n]
    krx = das_tiled(x, sub, pr, pv, nv, t0, 1 / 1540.0, fs=31.25e6, tx_model="plane",
                    im_shape=(16, n, 1), keep_rx=True, interpret=True)
    got = benches.ops.das_sum(xt, sub, pr, pv, nv, t0, 1 / 1540.0, fs=31.25e6,
                              tx_model="plane", method="linear", im_shape=(16, n, 1),
                              keep_rx=True)
    assert rel(got, krx) < F32


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_lut_sweep_matches_jax(method):
    x, n = traces((256, 16, 4)), 128
    pr, pv, nv, t0 = benches.sweep_geometry(16, 4)
    tr, tt = delay_tables(bench.pixels(n), pr, pv, nv, 1540.0, tx_model="plane")
    tau_rx, tau_tx, t0p = benches.lut_tables(16, 4, n, CPU)
    assert rel(tau_rx, tr) < 1e-6 and rel(tau_tx, tt) < 1e-6
    got = benches.ops.das_lut_sum(torch.as_tensor(x), tau_rx, tau_tx, t0p, fs=31.25e6,
                                  method=method, im_shape=(n, n, 1))
    ref = das_lut(x, np.asarray(tr), np.asarray(tt), t0, fs=31.25e6, method=method,
                       im_shape=(n, n, 1))
    assert rel(got, ref) < F32


@pytest.mark.parametrize("impl", ["freq", "splat", "pallas"])
def test_greens_sweep_matches_jax(impl):
    """Each engine's traces at the tiny sweep's clouds: 'freq' against
    ``greens_freq``; the splat and K5's plain version ('pallas') against
    ``greens_splat`` (linear, block 256) op by op: jitted on the CPU, the
    JAX splat of 256 scatterers lies 0.11 of the peak off its own
    ``greens_dense`` oracle (ROADMAP Queue 3), op by op 4.6e-5."""
    for S, (kern, ps, amp, pn, pv, kw) in benches.greens_clouds(16, 8):
        got = benches.greens_traces(impl, kern, ps, amp, pn, pv, CPU, **kw)
        if impl == "freq":
            ref = greens_freq(kern, ps, amp, pn, pv, **kw)
        else:
            with jax.disable_jit():
                ref = greens_splat(kern, ps, amp, pn, pv, method="linear", block=256, **kw)
        assert rel(got, ref) < F32, (impl, S)


@pytest.mark.parametrize("Mp", [16, 1])
@pytest.mark.parametrize("method", ["auto", "freq"])
def test_focus_bench_matches_jax(Mp, method):
    us, chd, seq = benches.focus_problem(256, 16, 16, CPU)
    got = us.focusTx(chd, seq(Mp), method=method, device=CPU).data
    xdc = q.TransducerArray(numel=16, pitch=0.2e-3, fc=5e6)
    jus = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=16, c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-1e-2, 1e-2, 4), z=np.linspace(1e-2, 3e-2, 4)),
        fs=31.25e6)
    foc = np.stack([np.linspace(-10e-3, 10e-3, Mp), np.zeros(Mp), np.full(Mp, 30e-3)], 0)
    jseq = q.Sequence(type="FC", focus=foc, c0=1540.0)
    jchd = q.ChannelData(data=traces((256, 16, 16)), fs=31.25e6, t0=0.0)
    ref = jus.focusTx(jchd, jseq, method=method)
    assert rel(got, ref.data) < F32


def test_adjoint_bench_matches_jax(monkeypatch):
    """The bench's bfAdjoint (bf16, the port's default) against JAX's on its
    accelerator engine (the Pallas kernel in interpret mode, bf16), direct
    sin/cos phasors on both sides (``QUPS_ADJ_RECUR=0``)."""
    monkeypatch.setenv("QUPS_ADJ_RECUR", "0")
    us, chd, bins = benches.adjoint_problem(benches.traces((256, 16, 16), CPU), 64, 16)
    assert bins.tolist() == list(range(41 - 8, 41 + 8))  # fc at bin 41 of 256
    got = us.bfAdjoint(chd, bins=bins, device=CPU)
    xdc = q.TransducerArray(numel=16, pitch=0.2e-3, fc=5e6)
    jus = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=16, c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-12e-3, 12e-3, 64), z=np.linspace(5e-3, 45e-3, 64)),
        fs=31.25e6)
    jchd = q.ChannelData(data=traces((256, 16, 16)), fs=31.25e6, t0=0.0)
    ref = jus.bfAdjoint(jchd, bins=bins, kernel="pallas")
    assert rel(got, ref) < ADJ


def test_refocus_bench_matches_jax():
    us, chd, enc = benches.refocus_problem(256, 16, 16, CPU)
    jus = q.UltrasoundSystem(
        tx=q.TransducerArray(numel=16, pitch=0.2e-3, fc=5e6),
        rx=q.TransducerArray(numel=16, pitch=0.2e-3, fc=5e6),
        seq=q.Sequence(type="FSA", numpulse=16, c0=1540.0),
        scan=q.ScanCartesian(x=[0.0], z=[20e-3]), fs=31.25e6)
    jenc = q.Sequence(type="FSA", numpulse=16, c0=1540.0, apd=benches.hadamard(16),
                      del_=np.zeros((16, 16)))
    jchd = q.ChannelData(data=traces((256, 16, 16)), fs=31.25e6, t0=0.0)
    ref = jus.refocus(jchd, jenc, gamma=0.0)
    benches.system._REFOCUS_OP_CACHE.clear()
    got = us.refocus(chd, enc, gamma=0.0, device=CPU)
    assert rel(got.data, ref.data) < F32
    cached = us.refocus(chd.replace(data=chd.data * 0.5), enc, gamma=0.0, device=CPU)
    assert rel(cached.data, 0.5 * np.asarray(ref.data)) < F32


def test_fdtd_bench_matches_jax_and_kwave():
    """The tiny bench's grid over 150 steps (the wave crosses to the
    recorded row by ~80; at the bench's 50 the record holds only the
    rounding ahead of the wavefront): with kappa = 1 against JAX's stepper,
    and at the bench's c_ref against the float64 k-Wave scheme."""
    maps, src, sig, kw = benches.fdtd_problem(64, 150)
    plain = {**kw, "c_ref": 0.0}
    got = fdtd.kspace_sim_2d(*maps, *src, sig, device=CPU, **plain)
    ref = jfdtd.kspace_sim_2d(*maps, *src, sig, **plain)
    assert rel(got, ref) < STEP_TOL
    got = fdtd.kspace_sim_2d(*maps, *src, sig, device=CPU, **kw)
    ref, _ = reference_stepper(*maps, np.stack(src), sig, steps=kw["steps"], dt=kw["dt"],
                               dx=kw["dx"], c_ref=kw["c_ref"], rows=kw["record_rows"],
                               npml=10)
    assert rel(got, ref) < STEP_TOL


@pytest.mark.parametrize("n", [64, 128])
def test_eikonal_bench_matches_jax(n):
    F, src = benches.eikonal_speed(n)
    np.testing.assert_array_equal(benches.ops.msfm(F, 0.2e-3, src), msfm(F, 0.2e-3, src))


def test_migration_bench_matches_jax():
    x = traces((512, 64, 4))
    got = benches.migration_image(torch.as_tensor(x))
    with jax.disable_jit():
        ref = stolt_migration(x, 0.0, np.zeros((64, 4), np.float32),
                                    tuple(np.linspace(-9.0, 9.0, 4)), fs=31.25e6, c0=1540.0,
                                    pitch=0.15e-3, out="complex")
    assert got.dtype == torch.complex64
    assert rel(got, ref) < F32


# ----------------------------------------------------------- the entry points
def _json_keys(path: Path) -> dict:
    """The keys of each JSON line a JAX bench file prints, from its source:
    {function name: [key sets of the dict literals passed to ``_emit`` or
    ``json.dumps``]}, a nested literal's keys as ``key.sub``, and for
    ``bench.py`` the ``detail`` dict built by name."""
    def keys(d, pre=""):
        out = set()
        for k, v in zip(d.keys, d.values):
            out.add(pre + k.value)
            if isinstance(v, ast.Dict):
                out |= keys(v, pre + k.value + ".")
        return out

    found = {}
    for fn in ast.parse(path.read_text()).body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        detail = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                    getattr(node.targets[0], "id", "") == "detail":
                detail |= keys(node.value, "detail.")
            if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                    and getattr(node.targets[0].value, "id", "") == "detail":
                sub = "detail." + node.targets[0].slice.value
                detail.add(sub)
                if isinstance(node.value, ast.Dict):
                    detail |= keys(node.value, sub + ".")
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and getattr(node.func, "id",
                                                      getattr(node.func, "attr", "")) in (
                    "_emit", "dumps") and node.args and isinstance(node.args[0], ast.Dict):
                ks = keys(node.args[0])
                if "detail" in ks and not any(k.startswith("detail.") for k in ks):
                    ks |= detail
                found.setdefault(fn.name, []).append(ks)
    return found


def _flat(rec, pre=""):
    out = set()
    for k, v in rec.items():
        out.add(pre + k)
        if isinstance(v, dict) and k in ("detail", "linear", "i8x4"):
            out |= _flat(v, pre + k + ".")
    return out


def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]


def test_bench_main_keys_and_check(tiny, capsys):
    """The headline at QUPS_BENCH_SIZE=small: one line, bench.py's keys
    (less ``upload_anomaly``), ``check`` the image's sum(|.|)."""
    tiny.setenv("QUPS_BENCH_SIZE", "small")
    tiny.setenv("QUPS_BENCH_REPS", "1")
    bench.main(["--device", "cpu"])
    (rec,) = _lines(capsys)
    jax_keys = next(k for k in _json_keys(ROOT / "bench.py")["main"] if "detail.method" in k)
    # upload_anomaly is TPU-only (the docstring names it); i8x4 needs its knob
    assert "upload_anomaly" in bench.__doc__
    assert _flat(rec) == {k for k in jax_keys
                          if not k.startswith(("detail.upload_anomaly", "detail.i8x4"))}
    assert "error" not in rec and rec["detail"]["device"] == "cpu"
    assert rec["detail"]["precision"] == "f32" and rec["detail"]["method"] == "cubic"
    x, pi, pr, pv, nv, t0 = bench.das_problem(**bench.CONFIGS["small"])
    img = bench.das_sum(torch.as_tensor(x), pi, pr, pv, nv, t0, bench.CINV, fs=bench.FS,
                        tx_model="plane", method="cubic", im_shape=(256, 256, 1))
    assert rec["detail"]["check"] == float(torch.sum(torch.abs(img)))
    assert rec["value"] > 0 and np.isfinite(rec["vs_baseline"])


def test_bench_main_mesh_lists_its_devices(tiny, capsys):
    """QUPS_BENCH_MESH on four shards of one device: bench.py's mesh keys
    and ``devices``; one distinct device, never reported as four."""
    tiny.setenv("QUPS_BENCH_SIZE", "small")
    tiny.setenv("QUPS_BENCH_REPS", "1")
    tiny.setenv("QUPS_BENCH_MESH", "rx2,tx2")
    bench.main(["--device", "cpu"])
    (rec,) = _lines(capsys)
    jax_keys = next(k for k in _json_keys(ROOT / "bench.py")["main"] if "detail.mesh" in k)
    assert _flat(rec) == jax_keys | {"detail.devices"}
    d = rec["detail"]
    assert d["devices"] == ["cpu"] * 4 and d["n_devices"] == 1 and d["mesh"] == {"rx": 2,
                                                                                 "tx": 2}
    assert d["per_chip_sums_per_s"] == rec["value"]


def test_benches_main_keys(tiny, capsys):
    """Every sweep at QUPS_BENCH_TINY=1: each line parses, holds no error,
    and carries the JAX line's keys."""
    assert benches.main(["all", "--device", "cpu"]) == 0
    lines = _lines(capsys)
    jax_keys = _json_keys(ROOT / "benches.py")
    seen = set()
    for rec in lines:
        assert "error" not in rec, rec
        name = rec["bench"]
        seen.add(name)
        assert set(rec) in jax_keys["bench_" + name], (name, set(rec))
        assert all(v > 0 for v in rec.values() if isinstance(v, float)), rec
    assert seen == set(benches.BENCHES)
    assert {r["bench"] for r in lines if "metric" in r} == seen
    for key in ("out=", "ri_split", "interpret=", "jax.jit"):
        assert key in benches.__doc__


def test_benches_main_fails_on_an_error(tiny, capsys, monkeypatch):
    """An injected failure prints an error line, the sweep goes on, and
    main() exits 1 naming the failure."""
    def broken(*a, **k):
        raise RuntimeError("injected")
    monkeypatch.setattr(benches.ops, "das_lut_sum", broken)
    assert benches.main(["lut", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    lines = [json.loads(s) for s in out.out.splitlines()]
    assert [r["method"] for r in lines] == ["linear", "cubic"]
    assert all(r["error"] == "RuntimeError: injected" for r in lines)
    assert "lut failed: RuntimeError: injected" in out.err
    assert benches.main(["eikonal", "--device", "cpu"]) == 0


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the default device raises; nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.headline()
    with pytest.raises(RuntimeError, match="CUDA"):
        benches.run("eikonal")


def test_port_reads_neither_jax_nor_the_root_benches():
    """The entry points import no JAX, no qups_tpu and neither root bench
    file; no module of the port, no tools/*_torch.py and not chip_smoke.py
    names one in an import."""
    code = ("import sys, qups_tpu_torch.bench, qups_tpu_torch.benches; "
            "bad = {'jax', 'qups_tpu', 'bench', 'benches'} & set(sys.modules); "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    files = [ROOT / "chip_smoke.py", *ROOT.glob("tools/*_torch.py"),
             *(p for p in ROOT.glob("qups_tpu_torch/**/*.py") if "_build" not in p.parts)]
    assert len(files) > 30
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "qups_tpu", "bench", "benches"), (path, name)
