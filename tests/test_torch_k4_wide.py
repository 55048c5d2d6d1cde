"""K4's wide route (K4(b) on the tensor cores where a block's phasor tiles
do not fit in shared memory: M + N past ~780) on the CPU, through its plain
versions: the host plan against csrc/fdbf.cu's constants and the resident
route's shared memory, the plain phasor table against
qups_tpu_torch.ops.fdbf.phasor rounded to bfloat16, and the plain
composition of the route (tables, real-block products, row sums per tile,
1 / ||A_i|| applied after the products, bins in groups and pixels in
chunks) against the JAX package's XLA adjoint and its Pallas engine in
interpret mode, for every keep mode, at M = 900 elements and V = 300
pulses. The kernels themselves run on the card in test_torch_cuda.py.

The problem is coherent: its traces are the echo of three of its pixels,
so the image has a peak, as a beamformed volume does. Tolerance,
max|port - JAX| < 2e-3 max|JAX|: the bf16 operands against the float32
XLA engine, and the bf16 band against the Pallas engine (different
summation orders round a few operands the other way)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qups_tpu.ops import fdbf as jfdbf  # noqa: E402
from qups_tpu.ops.fdbf_pallas import bf_adjoint_tiled  # noqa: E402
from qups_tpu_torch.ops import fdbf, fdbf_cuda  # noqa: E402
from test_torch_fdbf import _cu_constants, close  # noqa: E402

FS = 40e6
BINS = np.array([8, 9, 11, 12, 14])
KEEP = {"sum": {}, "rx": {"keep_rx": True}, "tx": {"keep_tx": True}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests (the suite runs several
    workers); restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def coherent_problem(T=64, N=48, M=900, V=300, I=128, seed=70):
    """Random delay tables, transmit delays and weights, and traces that
    are the echoes of pixels 0, 1 and 2 in the adjoint's own model:
    X_k[n, v] = sum_p e^{-2 pi i f_k tau_rx[p, n]} A_p(f_k, v), A_p the
    transmit field sum_m e^{-2 pi i f_k tau_tx[p, m]} apod e^{2 pi i f_k
    del_tx}, band-limited around BINS; t0 = t0_off = 0."""
    rng = np.random.default_rng(seed)
    tau_rx = rng.uniform(0, 2e-6, (I, N)).astype(np.float32)
    tau_tx = rng.uniform(0, 2e-6, (I, M)).astype(np.float32)
    del_tx = rng.uniform(0, 3e-7, (M, V)).astype(np.float32)
    apod = rng.standard_normal((M, V)).astype(np.float32)
    k = np.arange(T // 2 + 1)
    f = k * FS / T
    band = np.exp(-0.5 * ((k - 11) / 3.0) ** 2)
    X = np.zeros((k.size, N, V), np.complex128)
    for p in range(3):
        Ap = np.einsum("km,kmv->kv", np.exp(-2j * np.pi * f[:, None] * tau_tx[p]),
                       apod * np.exp(2j * np.pi * f[:, None, None] * del_tx))
        X += np.exp(-2j * np.pi * f[:, None, None] * tau_rx[p][None, :, None]) * Ap[:, None]
    x = np.fft.irfft(X * band[:, None, None], n=T, axis=0).astype(np.float32)
    zero = np.zeros(V, np.float32)
    return x, (tau_rx, tau_tx, del_tx, apod, zero, zero)


def wide_ops(x, args, keep, bins=BINS):
    tau_rx, tau_tx, del_tx, apod, t0, t0o = args
    _, fk, Xk, Sk = fdbf.adjoint_spectra(torch.as_tensor(x), del_tx, apod, t0, t0o, bins, fs=FS)
    ops = fdbf_cuda.adjoint_operands(fk, Xk, Sk, keep=keep, precision="bf16")
    assert ops["wide"]
    return ops, torch.as_tensor(tau_rx), torch.as_tensor(tau_tx)


def test_wide_plan_mirrors_the_kernel():
    """The wrapper's copies of fdbf.cu's wide-route tiles equal the
    source's; the route is taken exactly where the resident route's
    shared memory (its phasor tiles, with keep 'rx' one 64-column chunk of
    conj(Ahat), and the ring) exceeds a block's limit; the layout pads as
    the kernel's checks ask; the plan keeps its scratch within WIDE_BYTES
    (at the volume: one bin a group, all 64^3 voxels for keep '', two
    chunks of 131072 for 'rx' and 'tx')."""
    c = _cu_constants()
    assert (c["WM"], c["WVT"], c["WKC"]) == (fdbf_cuda.WM, fdbf_cuda.WVT, 2 * fdbf_cuda.WKROWS)
    assert c["WVT"] == c["WN"] // 2
    lim = fdbf_cuda.SMEM_LIMIT
    for M, N, V in ((128, 128, 5), (256, 256, 256), (390, 390, 1024), (400, 380, 64),
                    (900, 200, 24), (32, 1024, 1024), (1024, 12, 300), (1024, 1024, 1024)):
        for keep in ("", "rx", "tx"):
            vt, Mp, Np, Vp, _ = fdbf_cuda.tc_layout(M, N, V, keep)
            tiles = 2 * (64 * (2 * Mp + 8) + 3 * 32 * (2 * vt + 8)
                         + (64 * (2 * min(Vp, 64) + 8) if keep == "rx" else 64 * (2 * Np + 8)))
            assert fdbf_cuda.wide_route(M, N, V, keep) == (tiles > lim), (M, N, V, keep)
            assert not fdbf_cuda.wide_route(M, N, V, keep, "f32")
            Mw, Nw, Vw, Vz = fdbf_cuda.wide_layout(M, N, V, keep)
            q = fdbf_cuda.WKROWS
            assert Mw % q == 0 and Vw % 64 == 0 and Vz % q == 0 and V <= Vz <= Vw
            assert Nw % (64 if keep == "rx" else q) == 0 and Nw >= N and Mw >= M
    assert fdbf_cuda.wide_route(1024, 1024, 1024, "") and not fdbf_cuda.wide_route(
        256, 256, 256, "")
    budget = fdbf_cuda.WIDE_BYTES
    for keep, rows in (("", 262144), ("rx", 131072), ("tx", 131072)):
        plan = fdbf_cuda.wide_plan(262144, 1024, 1024, 1024, 64, keep)
        assert plan["bins"] == 1 and plan["rows"] == rows, (keep, plan)
        assert plan["scratch"] == plan["rows"] * plan["per"] <= budget
    # the bytes a pixel and bin: tables, row sums, the keep modes' scratch
    assert fdbf_cuda.wide_bytes(1024, 1024, 1024, "") == 4 * 1024 * 2 + 16 * 16
    assert fdbf_cuda.wide_bytes(1024, 1024, 1024, "tx") == 4 * 1024 * 2 + 16 * 16 + 4 + 8 * 1024
    assert fdbf_cuda.wide_bytes(1024, 1024, 1024, "rx") == 4 * 1024 + 16 * 16 + 4 + 12 * 1024
    for I, K in ((128, 5), (1000, 64), (262144, 7)):
        plan = fdbf_cuda.wide_plan(I, 900, 48, 300, K, "tx")
        assert 1 <= plan["bins"] <= K and plan["scratch"] <= budget
        assert plan["rows"] == I or plan["rows"] % fdbf_cuda.WM == 0


def test_phasor_table_plain_is_the_phasor_rounded():
    """The plain table: row (g, i) holds fdbf.phasor(fk[g], tau[i], sign)
    rounded to bfloat16, (Re, Im) interleaved, zero from L to Lp."""
    rng = np.random.default_rng(71)
    tau = torch.as_tensor(rng.uniform(0, 4e-5, (37, 21)).astype(np.float32))
    fk = torch.tensor([2.5e6, 3.125e6, 4e6])
    for sign in (-1.0, 1.0):
        W = fdbf_cuda.phasor_table_plain(fk, tau, sign, 32)
        assert W.dtype == torch.bfloat16 and W.shape == (3, 37, 64)
        W = W.reshape(3, 37, 32, 2)
        assert not bool(W[:, :, 21:].float().abs().any())
        for g in range(3):
            p = fdbf.phasor(fk[g], tau, sign)
            assert torch.equal(W[g, :, :21, 0], p.real.to(torch.bfloat16))
            assert torch.equal(W[g, :, :21, 1], p.imag.to(torch.bfloat16))
    # a CPU tensor takes the plain version
    assert torch.equal(fdbf_cuda.phasor_table(fk, tau, 1.0, 32),
                       fdbf_cuda.phasor_table_plain(fk, tau, 1.0, 32))


@pytest.mark.parametrize("keep", sorted(KEEP))
def test_wide_plain_matches_xla(keep):
    """The route's plain composition against the JAX package's XLA
    adjoint (float32) on the coherent problem: M = 900, V = 300."""
    x, args = coherent_problem()
    ops, taur, taut = wide_ops(x, args, "" if keep == "sum" else keep)
    ref = jfdbf.bf_adjoint(x, *args, BINS.astype(np.int32), fs=FS, **KEEP[keep])
    close(fdbf_cuda.adjoint_wide_plain(ops, taur, taut), ref, 2e-3)


@pytest.mark.parametrize("keep", sorted(KEEP))
def test_wide_plain_matches_pallas_interpret(keep, monkeypatch):
    """The same against the TPU kernel in interpret mode, bf16, one block
    of all 128 pixels (one chunk), direct phasors on both sides."""
    monkeypatch.setenv("QUPS_ADJ_RECUR", "0")
    x, args = coherent_problem()
    ops, taur, taut = wide_ops(x, args, "" if keep == "sum" else keep)
    ref = bf_adjoint_tiled(x, *args, BINS.astype(np.int32), fs=FS, precision="bf16", BI=128,
                           interpret=True, **KEEP[keep])
    close(fdbf_cuda.adjoint_wide_plain(ops, taur, taut), ref, 2e-3)


@pytest.mark.parametrize("keep", ["", "rx", "tx"])
def test_wide_plain_groups_and_chunks(keep, monkeypatch):
    """Bins in groups and pixels in chunks (a budget cut to force both)
    give the one-chunk result to float32 rounding (1e-5 of the peak: a
    pixel's sums depend on its own rows, and the bins are added in order
    either way; on the CPU the float32 products' blocking follows the row
    count, while the kernel repeats bit for bit, test_torch_cuda.py); the
    route equals the plain bf16 adjoint within 2e-3 of its peak."""
    x, args = coherent_problem(I=300, V=100, seed=72)
    ops, taur, taut = wide_ops(x, args, keep)
    one = fdbf_cuda.adjoint_wide_plain(ops, taur, taut)
    per = fdbf_cuda.wide_bytes(900, 48, 100, keep)
    for budget in (2 * 300 * per, 200 * per):
        monkeypatch.setattr(fdbf_cuda, "WIDE_BYTES", budget)
        plan = fdbf_cuda.wide_plan(300, 900, 48, 100, BINS.size, keep)
        assert (plan["bins"], plan["rows"]) == ((2, 300) if budget > 300 * per else (1, 256))
        close(fdbf_cuda.adjoint_wide_plain(ops, taur, taut), one, 1e-5)
    ref = fdbf.bf_adjoint(torch.as_tensor(x), *args, BINS, fs=FS, precision="bf16",
                          keep_rx=keep == "rx", keep_tx=keep == "tx")
    close(one, ref, 2e-3)
