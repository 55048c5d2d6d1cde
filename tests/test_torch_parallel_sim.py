"""The port's sharded simulators on the CPU (``qups_tpu_torch/parallel/
mesh.py``): ``greens_sharded`` (the scatter-add splat per shard),
``greens_freq_sharded`` (K3's GEMM per (scatterer, rx) block, one
reduction of the spectra, one synthesis), ``fdtd_sharded`` (each shard's
transmits one batch of the stepper), and the system's ``greens(mesh=)``,
``calc_scat_multi(mesh=)`` and ``kspaceFirstOrder(mesh=)``.

The counterparts of the simulator tests of ``tests/test_parallel.py`` on
its mesh shapes (k ``torch.device("cpu")`` entries for k virtual CPU
devices). Each sharded result is held to the port's own unsharded call and
to the JAX package's sharded function on the same inputs (its XLA engines;
``greens_freq_sharded(engine='pallas')`` in interpret mode once). The
steppers differ in their spectral derivative (``tests/test_torch_fdtd.py``),
so ``fdtd_sharded`` meets JAX's with kappa = 1 (``c_ref = 0``) and the
port's own loop otherwise; ``kspaceFirstOrder(mesh=)`` runs JAX's case
(``tests/test_parallel.py:647``) with the port's loop as the reference.

Tolerances, max|got - ref| against max|ref|: 1e-4, the float32 standard;
the system's simulated traces against the JAX package's 2e-4, as
``tests/test_torch_system.py`` holds them (XLA rounds the float32 delays
with fused multiply-adds and the port does not; measured 1.09e-4 with and
without a mesh); ``fdtd_sharded`` against the port's per-transmit stepper
1e-6, as ``tests/test_parallel.py:644`` (measured up to 6.7e-7: a shard's
batch of two or more transmits transforms the fields together, which
rounds as any batch of two or more does, and differently from one transmit
alone);
against JAX's stepper with kappa = 1 2e-4 (``tests/test_torch_fdtd.py``'s
stepper limit); ``kspaceFirstOrder(mesh=)`` against the loop 1e-5, as
``tests/test_parallel.py:667``, its t0 exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import qups_tpu as q  # noqa: E402
from qups_tpu.ops.greens import greens_splat as jgreens_splat  # noqa: E402
from qups_tpu.parallel import mesh as jmesh  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch import parallel  # noqa: E402
from qups_tpu_torch.ops.greens import greens_splat  # noqa: E402
from qups_tpu_torch.ops.greens_freq import greens_freq  # noqa: E402
from qups_tpu_torch.sim import fdtd  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-4
TRACES = 2e-4
STEP_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: the suite runs six workers
    on the machine's cores, and the many small operations of these calls
    (shard by shard, step by step) spin every thread a worker has, which
    slowed the other workers' tests several times over (measured in the
    full run: a test of 9.5 s alone took 670 s). Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_mesh(shape, axes):
    return parallel.make_mesh([CPU] * int(np.prod(shape)), axes=axes, shape=shape)


def jax_mesh(shape, axes):
    return jmesh.make_mesh(jax.devices()[:int(np.prod(shape))], axes=axes, shape=shape)


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = ref.numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0
    return float(np.abs(got - ref).max() / scale)


def cloud(S, N, M, seed, fs=5e6, K=21):
    """``tests/test_parallel.py``'s greens problem: a windowed 1 MHz kernel,
    S scatterers at 15-25 mm, N receivers and M transmitters in a line."""
    rng = np.random.default_rng(seed)
    kern = (np.hanning(K) * np.sin(2 * np.pi * 1e6 * np.arange(K) / fs)).astype(np.float32)
    ps = np.stack([rng.uniform(-3e-3, 3e-3, S), np.zeros(S), rng.uniform(15e-3, 25e-3, S)],
                  -1).astype(np.float32)
    amp = rng.standard_normal(S).astype(np.float32)
    pn = np.stack([np.linspace(-4e-3, 4e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)[:, None, :]
    pv = np.stack([np.linspace(-2e-3, 2e-3, M), np.zeros(M), np.zeros(M)],
                  -1).astype(np.float32)[:, None, :]
    return kern, ps, amp, pn, pv


KW = dict(T=96, s0=1.5e-5, t0k=-1e-6, fs=5e6, cinv=1 / 1540.0, R0=1e-3)


# ---------------------------------------------------------- greens_sharded
def test_greens_sharded_matches_single():
    """Scatterers over 'tx' (13 over 4 shards of blocks of 4), receivers
    over 'rx'; the splat per shard against the unsharded splat and JAX's
    sharded splat."""
    _, ps, amp, pn, pv = cloud(13, 4, 2, seed=1)
    kern = np.random.default_rng(1).standard_normal(21).astype(np.float32)
    kw = dict(KW, block=4)
    got = parallel.greens_sharded(port_mesh((2, 4), ("rx", "tx")), kern, ps, amp, pn, pv, **kw)
    assert got.shape == (96, 4, 2) and got.device == CPU
    assert rel(got, greens_splat(kern, ps, amp, pn, pv, device="cpu", **kw)) < TOL
    jref = jmesh.greens_sharded(jax_mesh((2, 4), ("rx", "tx")), kern, ps, amp, pn, pv, **kw)
    assert rel(got, jref) < TOL
    jone = jgreens_splat(kern, ps, amp, pn, pv, **kw)
    assert rel(got, jone) < TOL


def test_greens_sharded_nondivisible_rx():
    """N = 5 on a 2-wide rx axis: the receivers padded by their edge and
    the padding cropped. The JAX package's ``greens_sharded`` shards them
    unpadded and stops there (ROADMAP Queue 3)."""
    kern, ps, amp, pn, pv = cloud(9, 5, 3, seed=4)
    got = parallel.greens_sharded(port_mesh((2, 2), ("rx", "tx")), kern, ps, amp, pn, pv,
                                  block=2, **KW)
    assert rel(got, greens_splat(kern, ps, amp, pn, pv, device="cpu", block=2, **KW)) < TOL
    with pytest.raises(ValueError, match="evenly divisible"):
        jmesh.greens_sharded(jax_mesh((2, 2), ("rx", "tx")), kern, ps, amp, pn, pv, block=2,
                             **KW)


# ----------------------------------------------------- greens_freq_sharded
def test_greens_freq_sharded_matches_single():
    """S = 13 and N = 5, non-divisible on a (2, 4) mesh: the padded
    scatterers (edge positions, zero amplitudes) leave the plan of the
    unpadded cloud; real and complex kernels; against the unsharded engine
    and JAX's sharded one (XLA engine, and its Pallas engine in interpret
    mode)."""
    kern, ps, amp, pn, pv = cloud(13, 5, 2, seed=2)
    mesh, jm = port_mesh((2, 4), ("rx", "tx")), jax_mesh((2, 4), ("rx", "tx"))
    got = parallel.greens_freq_sharded(mesh, kern, ps, amp, pn, pv, **KW)
    assert got.dtype == torch.float32
    assert rel(got, greens_freq(kern, ps, amp, pn, pv, device="cpu", **KW)) < TOL
    assert rel(got, jmesh.greens_freq_sharded(jm, kern, ps, amp, pn, pv, engine="xla",
                                              **KW)) < TOL
    assert rel(got, jmesh.greens_freq_sharded(jm, kern, ps, amp, pn, pv, engine="pallas",
                                              **KW)) < TOL
    ck = kern.astype(np.complex64) * np.exp(1j * np.linspace(0, 1, 21)).astype(np.complex64)
    gotc = parallel.greens_freq_sharded(mesh, ck, ps, amp, pn, pv, **KW)
    assert gotc.dtype == torch.complex64
    assert rel(gotc, greens_freq(ck, ps, amp, pn, pv, device="cpu", **KW)) < TOL
    assert rel(gotc, jmesh.greens_freq_sharded(jm, ck, ps, amp, pn, pv, out="complex",
                                               **KW)) < TOL
    ca = (amp * np.exp(1j * np.linspace(0, 2, 13))).astype(np.complex64)
    assert rel(parallel.greens_freq_sharded(mesh, kern, ps, ca, pn, pv, **KW),
               greens_freq(kern, ps, ca, pn, pv, device="cpu", **KW)) < TOL


def test_greens_freq_sharded_attenuation():
    """alpha0 through the sharded engine (``tests/test_parallel.py:565``)."""
    fs, c0 = 20e6, 1500.0
    kern = np.hanning(41).astype(np.float32)
    rng = np.random.default_rng(2)
    S = 24
    ps = np.stack([rng.uniform(-3e-3, 3e-3, S), np.zeros(S), rng.uniform(10e-3, 20e-3, S)],
                  -1).astype(np.float32)
    amp = rng.uniform(0.5, 1.0, S).astype(np.float32)
    pn = np.stack([np.linspace(-3e-3, 3e-3, 6), np.zeros(6), np.zeros(6)],
                  -1)[:, None, :].astype(np.float32)
    pv = pn[:4].copy()
    kw = dict(T=int(2 * 25e-3 / c0 * fs) + 64, s0=0.0, t0k=0.0, fs=fs, cinv=1 / c0, R0=1e-3,
              alpha0=0.7)
    got = parallel.greens_freq_sharded(port_mesh((2, 2), ("rx", "tx")), kern, ps, amp, pn, pv,
                                       engine="plain", **kw)
    assert rel(got, greens_freq(kern, ps, amp, pn, pv, kernel="plain", device="cpu", **kw)) \
        < TOL
    jref = jmesh.greens_freq_sharded(jax_mesh((2, 2), ("rx", "tx")), kern, ps, amp, pn, pv,
                                     engine="xla", out="complex", **kw)
    assert rel(got, np.real(np.asarray(jref))) < TOL


def test_greens_freq_sharded_options():
    """bf16 operands per shard equal the unsharded bf16 engine (the same
    rounding of the same operands), sub-elements shard with their
    elements, and the refusals: 'cuda' on a CPU mesh, unknown engines and
    precisions."""
    kern, ps, amp, pn, pv = cloud(40, 6, 3, seed=6)
    mesh = port_mesh((2, 4), ("rx", "tx"))
    got = parallel.greens_freq_sharded(mesh, kern, ps, amp, pn, pv, precision="bf16", **KW)
    assert rel(got, greens_freq(kern, ps, amp, pn, pv, precision="bf16", device="cpu",
                                **KW)) < TOL
    pn2 = np.concatenate([pn - [1e-4, 0, 0], pn + [1e-4, 0, 0]], 1)
    assert rel(parallel.greens_freq_sharded(mesh, kern, ps, amp, pn2, pv, **KW),
               greens_freq(kern, ps, amp, pn2, pv, device="cpu", **KW)) < TOL
    for kw in (dict(engine="cuda"), dict(engine="pallas"), dict(precision="fp32")):
        with pytest.raises(ValueError):
            parallel.greens_freq_sharded(mesh, kern, ps, amp, pn, pv, **kw, **KW)


# -------------------------------------------------------------- fdtd_sharded
def fdtd_problem():
    """``tests/test_parallel.py:621``'s: a 64^2 grid with a density
    scatterer, 5 transmits of 3 source nodes."""
    rng = np.random.default_rng(5)
    c = np.full((64, 64), 1500.0, np.float32)
    rho = np.full((64, 64), 1000.0, np.float32)
    rho[40:44, 30:34] = 2000.0
    sig = rng.standard_normal((5, 48, 3)).astype(np.float32)
    idx = np.array([[12, 12, 12], [20, 32, 44]])
    return c, rho, idx, sig


def test_fdtd_sharded_matches_single():
    """5 transmits on a 4-wide 'tx' axis (2 a shard, the last padding
    only), against the port's stepper one transmit at a time."""
    c, rho, idx, sig = fdtd_problem()
    kw = dict(steps=48, dt=4e-8, dx=2e-4, c_ref=1500.0, record_rows=(8, 50))
    rec = parallel.fdtd_sharded(port_mesh((4,), ("tx",)), c, rho, idx, sig, **kw)
    assert rec.shape == (5, 48, 2, 64) and rec.device == CPU
    for v in range(5):
        ref = fdtd.kspace_sim_2d(c, rho, idx[0], idx[1], sig[v], device="cpu", **kw)
        assert float((rec[v] - ref).abs().max()) <= 1e-6 * float(ref.abs().max()), v


def test_fdtd_sharded_matches_jax_without_kappa():
    """With kappa = 1 (``c_ref = 0``) the two steppers are one scheme: the
    port's sharded simulation against JAX's ``fdtd_sharded``."""
    c, rho, idx, sig = fdtd_problem()
    kw = dict(steps=48, dt=4e-8, dx=2e-4, c_ref=0.0, record_rows=(8, 50))
    got = parallel.fdtd_sharded(port_mesh((4,), ("tx",)), c, rho, idx, sig, **kw)
    ref = jmesh.fdtd_sharded(jax_mesh((4,), ("tx",)), c, rho, idx, sig, **kw)
    assert rel(got, ref) < STEP_TOL


def test_fdtd_sharded_3d_and_absorbing():
    """A 3-D grid with absorption and B/A, 3 transmits on a (rx, tx) mesh
    whose 'tx' axis the transmits shard over."""
    rng = np.random.default_rng(8)
    n = 20
    c = np.full((n, n, n), 1500.0, np.float32)
    rho = np.full((n, n, n), 1000.0, np.float32)
    rho[12:15, 8:12, 8:12] = 1800.0
    a, b = np.full((n, n, n), 0.75), np.full((n, n, n), 8.0)
    sig = rng.standard_normal((3, 24, 2)).astype(np.float32)
    idx = np.array([[4, 4], [8, 12], [10, 10]])
    kw = dict(steps=24, dt=4e-8, dx=2e-4, c_ref=1500.0, record_rows=(16,), alpha0=a, bona=b,
              alpha_power=1.3)
    rec = parallel.fdtd_sharded(port_mesh((2, 2), ("rx", "tx")), c, rho, idx, sig, **kw)
    assert rec.shape == (3, 24, 1, n, n)
    ref = fdtd.kspace_sim_3d(c, rho, idx, torch.as_tensor(sig.transpose(1, 0, 2).copy()),
                             device="cpu", **kw).transpose(0, 1)
    assert rel(rec, ref) < TOL


# ------------------------------------------------------------ the system
def test_greens_system_mesh_matches_single():
    """``us.greens(mesh=)`` for 'freq' and 'splat' and
    ``us.calc_scat_multi(mesh=)`` (``tests/test_parallel.py:737``) against
    the calls without a mesh, and the JAX package's mesh calls on the same
    system."""
    def system(m):
        xdc = m.TransducerArray(numel=8, pitch=0.3e-3, fc=5e6)
        return m.UltrasoundSystem(
            tx=xdc, rx=xdc, seq=m.Sequence(type="FSA", numpulse=8),
            scan=m.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 16),
                                 z=np.linspace(17e-3, 23e-3, 16)), fs=25e6)

    us, jus = system(qt), system(q)
    scat = qt.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
    jscat = q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
    mesh, jm = port_mesh((2, 4), ("rx", "tx")), jax_mesh((2, 4), ("rx", "tx"))
    for impl in ("freq", "splat"):
        a = us.greens(scat, impl=impl, device="cpu").data
        b = us.greens(scat, impl=impl, mesh=mesh).data
        assert b.device == CPU and rel(b, a) < TOL, impl
        assert rel(b, np.asarray(jus.greens(jscat, impl=impl, mesh=jm).data)) < TRACES, impl
    us2 = us.replace(seq=qt.SequenceRadial(type="PW", angles=[-5.0, 5.0], c0=1540.0))
    c1 = us2.calc_scat_multi(scat, method="cubic", device="cpu").data
    c2 = us2.calc_scat_multi(scat, method="cubic", mesh=mesh).data
    assert rel(c2, c1) < TOL
    assert rel(us2.calc_scat_multi(scat, mesh=mesh).data, c1) < TOL  # 'auto' on a CPU mesh
    for impl in ("pallas", "dense"):
        with pytest.raises(ValueError, match="shards impl"):
            us.greens(scat, impl=impl, mesh=mesh)
    with pytest.raises(TypeError):
        us.greens(scat, mesh=jm)


def kfo_case(mod):
    """``tests/test_parallel.py:647``'s system, medium and grid."""
    c0, fc = 1500.0, 2e6
    lam = c0 / fc
    xdc = mod.TransducerArray(numel=6, pitch=lam / 2, fc=fc)
    us = mod.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=mod.Sequence(type="FSA", numpulse=6, c0=c0),
        scan=mod.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8), z=np.linspace(1e-3, 6e-3, 8)),
        fs=4 * fc)
    blob = lambda P: (np.hypot(P[0], P[2] - 4e-3) < lam / 4)  # noqa: E731
    med = mod.Medium(c0=c0, rho0=1000.0, pertreg=((blob, {"rho": 2000.0}),))
    cgrd = mod.ScanCartesian(x=np.arange(-3e-3, 3e-3, lam / 5), y=[0.0],
                             z=np.arange(-0.5e-3, 6.5e-3, lam / 5))
    return us, med, cgrd


def test_kspace_first_order_mesh_matches_loop():
    """``us.kspaceFirstOrder(mesh=)`` on 8 devices' 'tx' axis (6 transmits,
    2 of padding) against the port's own sequential path (one batch): the
    element projection, the union source set, the t0 conventions and the
    downsampling."""
    us, med, cgrd = kfo_case(qt)
    chd0 = us.kspaceFirstOrder(med, cgrd, device="cpu")
    chd1 = us.kspaceFirstOrder(med, cgrd, mesh=port_mesh((8,), ("tx",)))
    assert chd1.data.shape == chd0.data.shape == (chd0.data.shape[0], 6, 6)
    assert rel(chd1.data, chd0.data) < 1e-5
    assert np.abs(chd0.t0_host - chd1.t0_host).max() == 0.0


def test_kspace_first_order_mesh_bg_subtract_and_field():
    """bg_subtract on the mesh (both simulations sharded); record='field'
    runs the transmits as without a mesh and returns the same snapshots."""
    us, med, cgrd = kfo_case(qt)
    mesh = port_mesh((2, 2), ("rx", "tx"))
    a = us.kspaceFirstOrder(med, cgrd, bg_subtract=True, tmax=6e-6, device="cpu")
    b = us.kspaceFirstOrder(med, cgrd, bg_subtract=True, tmax=6e-6, mesh=mesh)
    assert rel(b.data, a.data) < 1e-5
    (ca, fa), (cb, fb) = (us.kspaceFirstOrder(med, cgrd, record="field", field_stride=20,
                                              tmax=4e-6, **kw)
                          for kw in (dict(device="cpu"), dict(mesh=mesh)))
    assert torch.equal(cb.data, ca.data) and torch.equal(fb, fa)
    with pytest.raises(TypeError):
        us.kspaceFirstOrder(med, cgrd, mesh=object())
