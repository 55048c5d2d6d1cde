"""The port's time-domain splat simulator (qups_tpu_torch.ops.greens_cuda,
the host plan and the plain version of kernel K5) against qups_tpu's
greens_pallas: the chunk windows, the deposit grid against the TPU kernel
run in interpret mode, whole simulations against greens_tiled(interpret=
True) for both bases, a complex kernel and sub-elements, and
UltrasoundSystem.greens(impl='pallas') in both packages.

Tolerance: max|port - JAX| < 1e-4 max|JAX|. The port keeps the TPU
kernel's order of operations; what remains is XLA's fused multiply-adds on
the CPU (ROADMAP Queue 3), measured at 3.5e-5 of the peak here."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qups_tpu as q  # noqa: E402
from qups_tpu.ops.greens_pallas import _plan_scat_windows as windows_ref  # noqa: E402
from qups_tpu.ops.greens_pallas import _splat_tiled  # noqa: E402
from qups_tpu.ops.greens_pallas import greens_tiled as greens_tiled_ref  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import greens_cuda  # noqa: E402
from qups_tpu_torch.ops.greens_cuda import (_plan_scat_windows, greens_tiled,  # noqa: E402
                                            plan_tiled, plan_tiled_device, splat,
                                            splat_plain)

TOL = 1e-4


def problem(seed, S=10, N=6, M=3, T=128, K=15, fs=15e6, c0=1540.0):
    """The sizes of tests/test_greens_pallas.py, from a seed."""
    rng = np.random.default_rng(seed)
    kern = (np.hanning(K) * np.sin(2 * np.pi * 4e6 * np.arange(K) / fs)).astype(np.float32)
    ps = np.stack([rng.uniform(-3e-3, 3e-3, S), np.zeros(S),
                   rng.uniform(8e-3, 12e-3, S)], -1).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, S).astype(np.float32)
    pn = np.stack([np.linspace(-5e-3, 5e-3, N), np.zeros(N), np.zeros(N)],
                  -1)[:, None, :].astype(np.float32)
    pv = np.stack([np.linspace(-3e-3, 3e-3, M), np.zeros(M), np.zeros(M)],
                  -1)[:, None, :].astype(np.float32)
    s0 = 2 * 8e-3 / c0 - 1e-6
    t0k = -K / 2 / fs
    return kern, ps, amp, pn, pv, dict(T=T, s0=s0, t0k=t0k, fs=fs, cinv=1 / c0, R0=1e-3)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("Q", [1, 4])
def test_windows_match_reference(Q):
    rng = np.random.default_rng(20)
    S, M, ntiles, CS = 300, 4, 40, 32
    u = np.sort(rng.uniform(0, 300, S))
    U = u + rng.uniform(0, 30, S)
    a2 = rng.uniform(0, 20, (S, M))
    got = _plan_scat_windows(u, U, a2, ntiles, CS, Q=Q)
    ref = windows_ref(u, U, a2, ntiles, CS, Q=Q)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def _jax_grid(plan, en=0, em=0):
    """The TPU kernel, in interpret mode, on the port's plan: its (8, Spad)
    / (8, Npad) / (8, Mpad) layouts and (NB, M, ntiles) windows."""
    lo, nc, scat, st = plan["lo"], plan["nc"], plan["scat"], plan["st"]
    Npad, M = plan["pn"].shape[2], plan["pv"].shape[2]
    NB = Npad // 128
    s8 = np.zeros((8, scat.shape[0]), np.float32)
    s8[:4] = scat.T
    pn8 = np.zeros((8, Npad), np.float32)
    pn8[:3] = plan["pn"][en]
    pv8 = np.zeros((8, -(-M // 128) * 128), np.float32)
    pv8[:3, :M] = plan["pv"][em]
    return np.asarray(_splat_tiled(
        jnp.asarray(np.broadcast_to(lo, (NB,) + lo.shape).copy()),
        jnp.asarray(np.broadcast_to(nc, (NB,) + nc.shape).copy()),
        jnp.asarray(s8), jnp.asarray(pn8), jnp.asarray(plan["ofs_pad"][None]),
        jnp.asarray(pv8), Gtime=st["Gtime"], CS=st["CS"], cinv_fs=st["cinv_fs"],
        pconst=st["pconst"], R0=st["R0"], basis=st["basis"], interpret=True))


def _port_grid(plan, en=0, em=0, fn=splat):
    """The port's grid on a plan of plan_tiled_device (CPU tensors)."""
    return fn(plan["lo"], plan["hi"], plan["scat"], plan["pn"][en], plan["ofs_pad"],
              plan["pv"][em], **plan["st"])


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_grid_matches_tpu_kernel(method):
    """The deposit grid: the plain K5 on the device plan against the TPU
    kernel (interpret mode) on the numpy plan, which is the same plan
    (test_device_plan_matches_numpy)."""
    kern, ps, amp, pn, pv, kw = problem(21)
    plan = plan_tiled(kern, ps, amp, pn, pv, method=method, CS=32, **kw)
    dplan = plan_tiled_device(kern, ps, amp, pn, pv, method=method, device="cpu", **kw)
    got = _port_grid(dplan).numpy()
    ref = _jax_grid(plan)
    assert got.shape == ref.shape == (3, plan["st"]["Gtime"], 128)
    assert _rel(got, ref) < TOL


def test_plain_ignores_windows():
    """splat_plain takes no windows: empty windows leave its grid as it is,
    and the CPU wrapper runs it without a launch."""
    kern, ps, amp, pn, pv, kw = problem(22)
    plan = plan_tiled_device(kern, ps, amp, pn, pv, method="cubic", device="cpu", **kw)
    before = greens_cuda.LAUNCHES
    g = _port_grid(plan)
    assert greens_cuda.LAUNCHES == before
    plan0 = dict(plan, hi=plan["lo"].clone())
    assert torch.equal(_port_grid(plan0, fn=splat_plain), g)
    with pytest.raises(ValueError, match="basis"):
        _port_grid(dict(plan, st=dict(plan["st"], basis="lanczos3")))


def _case(case):
    """Problems of the plan tests: an even and an odd count of scatterers,
    sub-elements, a resampled kernel, and 9 transmits over a wider array."""
    kw2 = {"even S": {}, "odd S": dict(S=11), "subelements": dict(S=6, N=4, M=2, T=96),
           "resampled": {}, "wide": dict(S=40, N=150, M=9)}[case]
    kern, ps, amp, pn, pv, kw = problem(30, **kw2)
    if case == "subelements":
        pn = np.concatenate([pn + np.float32([0.2e-3, 0, 0]),
                             pn - np.float32([0.2e-3, 0, 0])], axis=1)
        pv = np.concatenate([pv, pv + np.float32([0.1e-3, 0, 0])], axis=1)
    if case == "resampled":
        kw = dict(kw, fsr=2.0)
    return kern, ps, amp, pn, pv, kw


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("case", ["even S", "odd S", "subelements", "resampled", "wide"])
def test_device_plan_matches_numpy(case, method):
    """plan_tiled_device on CPU tensors against the numpy plan_tiled (the
    JAX package's plan): the same row offsets, scatterer order and packing
    (the numpy plan's rows before its padding to CS), P0, Gtime, receiver
    and transmit rows and kernel. For an even count the
    median is the mean of the two middle rows, where torch.median would take
    the lower."""
    kern, ps, amp, pn, pv, kw = _case(case)
    ref = plan_tiled(kern, ps, amp, pn, pv, method=method, CS=32, **kw)
    got = plan_tiled_device(kern, ps, amp, pn, pv, method=method, device="cpu", **kw)
    assert (got["P0"], got["st"]["Gtime"]) == (ref["P0"], ref["st"]["Gtime"])
    np.testing.assert_array_equal(got["scat"].numpy(), ref["scat"][:ps.shape[0]])
    for k in ("ofs", "ofs_pad", "pn", "pv"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_array_equal(got["kern"], ref["kern"])
    assert got["st"]["pconst"] == ref["st"]["pconst"]
    assert got["st"]["cinv_fs"] == ref["st"]["cinv_fs"]
    M, Npad = ref["pv"].shape[2], ref["pn"].shape[2]
    assert got["lo"].shape == got["hi"].shape == (M, -(-ref["st"]["Gtime"] // greens_cuda.BAND),
                                                  Npad // 32)
    if case == "even S":
        cn = np.asarray(pn, np.float32).mean(axis=1)
        a1 = kw["cinv"] * kw["fs"] * np.linalg.norm(ps[:, None, :] - cn[None], axis=-1)
        assert not np.array_equal(torch.median(torch.as_tensor(a1), 0).values.numpy(),
                                  np.median(a1, axis=0))


def _taps(plan, m, method):
    """(sorted scatterer, receiver, row) of every nonzero tap of transmit m in
    a device plan's grid, the rows p computed as splat_plain computes them."""
    st, sc = plan["st"], plan["scat"]
    pn, pv, ofs = plan["pn"][0], plan["pv"][0], plan["ofs_pad"]
    cinv_fs, pconst = (float(np.float32(st[k])) for k in ("cinv_fs", "pconst"))
    r1 = torch.sqrt(sum((sc[:, i:i + 1] - pn[i][None]) ** 2 for i in range(3)))
    r2 = torch.sqrt(sum((sc[:, i:i + 1] - pv[i, m]) ** 2 for i in range(3)))
    p = (cinv_fs * (r1 + r2) + pconst) - ofs[None]  # (Spad, Npad)
    sup = 2 if method == "cubic" else 1
    out = []
    for o in range(-sup, sup + 1):
        j = torch.floor(p).to(torch.int64) + o
        ok = ((j - p).abs() < sup) & (j >= 0) & (j < st["Gtime"]) & (sc[:, 3:] != 0)
        s, n = torch.nonzero(ok, as_tuple=True)
        out.append(torch.stack((s, n, j[s, n]), 1))
    return torch.cat(out)


@pytest.mark.parametrize("band", [16, 32])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_band_windows_conservative(method, band, monkeypatch):
    """Brute force over every (scatterer, m, n): each nonzero tap's row lies
    in a band whose window, for the receiver's group of 32, holds the
    scatterer. 150 receivers padded to 8 groups (the pad lanes replicate the
    last receiver), sub-elements on the receive side, several bands."""
    kern, ps, amp, pn, pv, kw = problem(31, S=50, N=150, M=4)
    pn = np.concatenate([pn + np.float32([0.1e-3, 0, 0]), pn], axis=1)
    monkeypatch.setattr(greens_cuda, "BAND", band)
    plan = plan_tiled_device(kern, ps, amp, pn, pv, method=method, device="cpu", **kw)
    lo, hi = plan["lo"], plan["hi"]
    assert lo.shape[1] > 2 and lo.shape[2] == 8
    for m in range(lo.shape[0]):
        s, n, j = _taps(plan, m, method).T
        assert s.numel() > 0
        b, g = j // band, n // 32
        assert bool(((lo[m, b, g] <= s) & (s < hi[m, b, g])).all()), m
    # and the windows are far from the whole cloud
    assert greens_cuda.visits(plan) < 0.5 * lo.numel() * 32 * plan["scat"].shape[0]


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_windowed_grid_equals_plain(method, monkeypatch):
    """K5's design on the CPU: each (m, band, group) adds only the taps of
    its window's scatterers that fall in its rows and lanes; the bands put
    together are splat_plain's grid (to the order of the sums). Bands of 16
    rows, so that this small grid has several."""
    kern, ps, amp, pn, pv, kw = problem(32, S=40, N=70, M=3)
    band = 16
    monkeypatch.setattr(greens_cuda, "BAND", band)
    plan = plan_tiled_device(kern, ps, amp, pn, pv, method=method, device="cpu", **kw)
    args = (plan["scat"], plan["pn"][0], plan["ofs_pad"], plan["pv"][0])
    ref = splat_plain(plan["lo"], plan["hi"], *args, **plan["st"])
    got = torch.zeros_like(ref)
    Gtime = plan["st"]["Gtime"]
    one = torch.zeros((1, plan["lo"].shape[1], 1), dtype=torch.int32)
    for m in range(ref.shape[0]):
        for b in range(plan["lo"].shape[1]):
            for g in range(plan["lo"].shape[2]):
                lo, hi = int(plan["lo"][m, b, g]), int(plan["hi"][m, b, g])
                if hi <= lo:
                    continue
                sub = splat_plain(one, one, plan["scat"][lo:hi], args[1][:, g * 32:(g + 1) * 32],
                                  args[2][g * 32:(g + 1) * 32], args[3][:, m:m + 1],
                                  **plan["st"])
                rows = slice(b * band, min(Gtime, (b + 1) * band))
                got[m, rows, g * 32:(g + 1) * 32] = sub[0, rows]
    assert float((got - ref).abs().max()) < 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("case", ["cubic subelements", "long kernel"])
def test_complex_kernel_finish_matches_reference(case):
    """The plain finish with a complex kernel, through greens_tiled, against
    JAX greens_tiled(interpret=True): with sub-elements (cubic), and a
    80-tap kernel, past convd's direct method (an FFT)."""
    kern, ps, amp, pn, pv, kw = problem(33, S=8, N=5, M=3, T=110)
    method = "cubic"
    if case == "cubic subelements":
        pn = np.concatenate([pn + np.float32([0.15e-3, 0, 0]), pn], axis=1)
    else:
        kern = np.interp(np.arange(80) * 15 / 80, np.arange(15), kern).astype(np.float32)
        kw = dict(kw, t0k=-40 / kw["fs"])
        method = "linear"
    kern = kern.astype(np.complex64) * np.exp(
        1j * np.linspace(0, 2 * np.pi, kern.size)).astype(np.complex64)
    ref = np.asarray(greens_tiled_ref(kern, ps, amp, pn, pv, method=method, out="complex",
                                      interpret=True, CS=32, **kw))
    got = greens_tiled(kern, ps, amp, pn, pv, method=method, CS=32, device="cpu", **kw)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) < TOL


def test_finish_on_cpu_runs_the_plain_version():
    """finish on CPU tensors is finish_plain, with no launch: row offsets as
    numpy or as a tensor, and a complex kernel as its two parts."""
    rng = np.random.default_rng(34)
    grid = torch.as_tensor(rng.standard_normal((3, 40, 128)).astype(np.float32))
    kr, ki = (torch.as_tensor(rng.standard_normal(9).astype(np.float32)) for _ in range(2))
    ofs = rng.integers(0, 10, 7)
    before = greens_cuda.FINISH_LAUNCHES
    x = greens_cuda.finish(grid, torch.complex(kr, ki), T=30, P0=5, ofs=ofs)
    assert greens_cuda.FINISH_LAUNCHES == before and x.shape == (30, 7, 3)
    assert torch.equal(x.real, greens_cuda.finish_plain(grid, kr, T=30, P0=5,
                                                        ofs=torch.as_tensor(ofs)))
    assert torch.equal(x.imag, greens_cuda.finish_plain(grid, ki, T=30, P0=5, ofs=ofs))
    # x[t, n, m] = sum_k kern[k] grid[m, t + P0 - ofs[n] - k, n]
    t, n, m = 12, 3, 1
    rows = t + 5 - int(ofs[n]) - np.arange(9)
    want = sum(float(kr[k]) * float(grid[m, r, n]) for k, r in enumerate(rows) if 0 <= r < 40)
    assert abs(float(x.real[t, n, m]) - want) < 1e-5


def test_splat_checks_its_windows():
    """Windows of another shape than (M, ceil(Gtime / BAND), Npad / 32)
    are refused."""
    kern, ps, amp, pn, pv, kw = problem(35)
    plan = plan_tiled_device(kern, ps, amp, pn, pv, device="cpu", **kw)
    with pytest.raises(ValueError, match="lo and hi"):
        _port_grid(dict(plan, lo=plan["lo"][:, :, :2], hi=plan["hi"][:, :, :2]))
    lo, hi = (torch.cat((plan[k], plan[k][:, :1]), 1) for k in ("lo", "hi"))
    with pytest.raises(ValueError, match="lo and hi"):
        _port_grid(dict(plan, lo=lo, hi=hi))


@pytest.mark.parametrize("case", ["linear", "cubic", "complex_kernel", "subelements",
                                  "resampled"])
def test_greens_tiled_matches_reference(case):
    """Whole simulations against JAX greens_tiled(interpret=True), at the
    sizes of tests/test_greens_pallas.py (CS = 32)."""
    seed = {"linear": 0, "cubic": 1, "complex_kernel": 2, "subelements": 3,
            "resampled": 4}[case]
    if case in ("complex_kernel", "subelements"):
        kern, ps, amp, pn, pv, kw = problem(seed, S=6, N=4, M=2, T=96)
    else:
        kern, ps, amp, pn, pv, kw = problem(seed)
    method = "cubic" if case in ("cubic", "subelements") else "linear"
    out = "auto"
    if case == "complex_kernel":
        kern = kern.astype(np.complex64) * np.exp(
            1j * np.linspace(0, np.pi, kern.size)).astype(np.complex64)
        out = "complex"
    if case == "subelements":
        pn = np.concatenate([pn + np.float32([0.2e-3, 0, 0]),
                             pn - np.float32([0.2e-3, 0, 0])], axis=1)
        pv = np.concatenate([pv, pv + np.float32([0.1e-3, 0, 0])], axis=1)
    if case == "resampled":
        kw = dict(kw, fsr=2.0)
        kern = np.interp(np.arange(30) / 2.0, np.arange(15), kern).astype(np.float32)
    ref = np.asarray(greens_tiled_ref(kern, ps, amp, pn, pv, method=method, out=out,
                                      interpret=True, CS=32, **kw))
    got = greens_tiled(kern, ps, amp, pn, pv, method=method, CS=32, device="cpu", **kw)
    assert got.dtype == (torch.complex64 if case == "complex_kernel" else torch.float32)
    assert _rel(got.numpy(), ref) < TOL


def test_plain_kernel_equals_auto_on_cpu():
    kern, ps, amp, pn, pv, kw = problem(5)
    a = greens_tiled(kern, ps, amp, pn, pv, CS=32, device="cpu", **kw)
    b = greens_tiled(kern, ps, amp, pn, pv, CS=32, kernel="plain", device="cpu", **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        greens_tiled(kern, ps, amp, pn, pv, kernel="cuda", device="cpu", **kw)
    with pytest.raises(ValueError, match="linear/cubic"):
        greens_tiled(kern, ps, amp, pn, pv, method="lanczos3", device="cpu", **kw)
    with pytest.raises(ValueError, match="real amplitudes"):
        greens_tiled(kern, ps, amp * 1j, pn, pv, device="cpu", **kw)


def test_slabs_add():
    """More scatterers than SLAB go in slabs whose traces add. Each slab
    plans its own row offsets, so the rows round differently: 1e-4."""
    kern, ps, amp, pn, pv, kw = problem(6, S=12)
    whole = greens_tiled(kern, ps, amp, pn, pv, CS=32, device="cpu", **kw)
    old = greens_cuda.SLAB
    greens_cuda.SLAB = 5
    try:
        slabs = greens_tiled(kern, ps, amp, pn, pv, CS=32, device="cpu", **kw)
    finally:
        greens_cuda.SLAB = old
    assert float((slabs - whole).abs().max()) < TOL * float(whole.abs().max())


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_empty_window(cplx):
    """No deposit reaches the output window: zeros. The JAX package returns
    float32 zeros even for a complex kernel (ROADMAP Queue 3); the port
    returns complex64 zeros, as its non-empty path does. The values agree."""
    kern, ps, amp, pn, pv, kw = problem(7)
    if cplx:
        kern = kern.astype(np.complex64) * np.complex64(1j)
    kw = dict(kw, s0=kw["s0"] + 1e-3)  # the echoes end before s0
    ref = np.asarray(greens_tiled_ref(kern, ps, amp, pn, pv, interpret=True,
                                      CS=32, out="complex", **kw))
    got = greens_tiled(kern, ps, amp, pn, pv, CS=32, device="cpu", **kw)
    assert ref.dtype == np.float32 and ref.shape == tuple(got.shape)
    assert got.dtype == (torch.complex64 if cplx else torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


def _system(seq=None, numel=8):
    xdc = q.TransducerArray(numel=numel, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=seq or q.Sequence(type="FSA", numpulse=numel),
        scan=q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 16),
                             z=np.linspace(16e-3, 24e-3, 16)), fs=12e6)
    rng = np.random.default_rng(23)
    pos = np.stack([rng.uniform(-2e-3, 2e-3, 6), np.zeros(6), rng.uniform(18e-3, 22e-3, 6)])
    scat = q.Scatterers(pos=pos, amp=rng.uniform(0.5, 1.5, 6), c0=1540.0)
    return us, from_reference(us), scat, from_reference(scat)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's greens(impl='pallas') with its kernel in interpret
    mode, as its own tests run the kernel on the CPU."""
    import functools

    import qups_tpu.ops.greens_pallas as gp
    monkeypatch.setattr(gp, "greens_tiled",
                        functools.partial(greens_tiled_ref, interpret=True))


def _complex_pulse():
    """A complex (analytic) Gaussian tone burst at 3 MHz."""
    return q.Waveform(fun=lambda t: np.exp(2j * np.pi * 3e6 * t - (t / 2.5e-7) ** 2),
                      t0=-1e-6, tend=1e-6)


@pytest.mark.parametrize("case", ["FSA cubic", "FSA linear", "PW", "FSA complex pulse",
                                  "PW complex pulse"])
def test_system_greens_pallas_matches_reference(case, pallas_interpret):
    """UltrasoundSystem.greens(impl='pallas') in both packages: the splat,
    then focusTx (identity for FSA, the cubic sampler for plane waves). A
    complex pulse takes the complex branch, which focuses with t0 = s0 + dt0
    in float64."""
    pulse = _complex_pulse() if "complex" in case else None
    if case.startswith("PW"):
        seq = q.SequenceRadial(type="PW", angles=np.array([-5.0, 5.0]), c0=1540.0)
    else:
        seq = q.Sequence(type="FSA", numpulse=8)
    if pulse is not None:
        seq = dataclasses.replace(seq, pulse=pulse)
    us, ust, scat, scatt = _system(seq)
    method = "linear" if case == "FSA linear" else "auto"
    ref = us.greens(scat, impl="pallas", method=method)
    got = ust.greens(scatt, impl="pallas", method=method, device="cpu")
    r = np.asarray(ref.data)
    assert got.data.dtype == (torch.complex64 if np.iscomplexobj(r) else torch.float32)
    np.testing.assert_array_equal(np.asarray(got.t0, np.float32),
                                  np.asarray(ref.t0, np.float32))
    assert _rel(got.data.numpy(), r) < TOL


def test_system_greens_pallas_psf():
    """greens(impl='pallas') then DAS: the image peak within 1.1 mm of a
    lone scatterer (the BFTest oracle)."""
    _, ust, _, _ = _system()
    target = np.array([0.5e-3, 0.0, 20e-3])
    chd = ust.greens(from_reference(q.Scatterers(pos=target[:, None], c0=1540.0)), device="cpu",
                     impl="pallas")
    b = ust.DAS(chd, device="cpu")
    P = ust.scan.positions().reshape(3, -1)
    assert np.linalg.norm(P[:, int(b.abs().reshape(-1).argmax())] - target) < 1.1e-3
