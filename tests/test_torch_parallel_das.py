"""The port's mesh and its sharded DAS on the CPU (``qups_tpu_torch/
parallel/mesh.py``): ``make_mesh`` and ``_factor``, ``das_sharded``,
``das_sharded_pallas`` (K1 per shard; the plain version on the CPU) with
its plan, keep modes, frames, IQ, fused apodization and the in-mesh
coherence reductions, ``das_lut_sharded_pallas`` (K2 per shard), and
``UltrasoundSystem.coherence_image(mesh=)``.

The counterparts of the DAS tests of ``tests/test_parallel.py`` (and of
``tests/test_coherence.py:101``, ``tests/test_sweep.py:211``), on the same
mesh shapes: a mesh of k ``torch.device("cpu")`` entries where the JAX test
has k virtual CPU devices. Each sharded result is held to the port's own
unsharded call, and to the JAX package's sharded function on the same
inputs: its XLA ``das_sharded``, or ``das_sharded_pallas`` /
``das_lut_sharded_pallas`` in interpret mode (three cases each at most,
``tests/test_torch_cheat_sheet.py``'s one among them), as
``tests/test_parallel.py`` runs them, else its XLA ``das``.

Tolerances, max|got - ref| against max|ref|: 1e-4, the float32 standard
(``das_pallas.py:2424``); 'bf16pair' 1e-4 against the same precision (the
same rounded taps) and 2e-2 against float32 (the TPU tests' band); the
coherence reductions 1e-4 (cohfac) and 1e-3 (slsc: unit-normalised
samples at the rounding floor, as ``tests/test_torch_coherence.py``), also
against the JAX package's; ``coherence_image(mesh=)`` against the JAX
package's mesh path 5e-3 (its own test's limit against its fallback).
"""
import inspect
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import qups_tpu as q  # noqa: E402
from qups_tpu.ops.coherence import cohfac as jcohfac, slsc as jslsc  # noqa: E402
from qups_tpu.ops.das import das as jdas, das_lut as jdas_lut  # noqa: E402
from qups_tpu.parallel import mesh as jmesh  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch import parallel  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import das_cuda  # noqa: E402
from qups_tpu_torch.ops.coherence import cohfac, slsc  # noqa: E402
from qups_tpu_torch.ops.das import das, das_lut  # noqa: E402
from qups_tpu_torch.parallel import mesh as pmesh  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-4
BAND = 2e-2
SLSC = 1e-3
CINV = 1 / 1540.0


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
    assert scale > 0  # no vacuous all-zero comparison
    return float(np.abs(got - ref).max() / scale)


def das_problem(T=128, N=8, M=4, I=36, F=None):
    """``tests/test_parallel.py::_das_problem``."""
    rng = np.random.default_rng(3)
    shape = (T, N, M) if F is None else (T, N, M, F)
    x = rng.standard_normal(shape).astype(np.float32)
    pi = np.stack([np.linspace(-5e-3, 5e-3, I), np.zeros(I),
                   np.linspace(20e-3, 30e-3, I)], -1).astype(np.float32)
    pr = np.stack([np.linspace(-4e-3, 4e-3, N), np.zeros(N), np.zeros(N)], -1)
    pv = np.stack([np.linspace(-3e-3, 3e-3, M), np.zeros(M), np.zeros(M)], -1)
    nv = np.tile([0.0, 0.0, 1.0], (M, 1))
    t0 = (25e-6 + np.linspace(0, 1e-6, M)).astype(np.float32)
    return x, pi, pr.astype(np.float32), pv.astype(np.float32), nv.astype(np.float32), t0


def shard_problem(N=24, M=6, T=256, I1=16, I2=128, F=None, cplx=False, seed=7):
    """``tests/test_parallel.py::_shard_problem``."""
    rng = np.random.default_rng(seed)
    shape = (T, N, M) + ((F,) if F else ())
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
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


PW = dict(fs=4e6, tx_model="plane")
IM = (16, 128, 1)


def k1(x, pi, pr, pv, nv, t0, **kw):
    """The port's unsharded K1 call (its plain version on the CPU)."""
    return das_cuda.das_sum(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, **PW, **kw)


# ------------------------------------------------------------------ mesh
def test_mesh_factorization():
    m = parallel.make_mesh([CPU] * 8)
    assert int(np.prod(list(m.shape.values()))) == 8
    m2 = parallel.make_mesh([CPU] * 8, axes=("rx", "tx"), shape=(4, 2))
    assert m2.shape["rx"] == 4 and m2.axis_names == ("rx", "tx")
    assert m2.devices.shape == (4, 2) and m2.devices.flat[0] == CPU
    for n in range(1, 9):
        for axes in (("frame", "rx", "tx"), ("rx", "tx"), ("tx",)):
            assert pmesh._factor(n, len(axes)) == jmesh._factor(n, len(axes))
            assert parallel.make_mesh([CPU] * n, axes=axes).shape \
                == dict(jmesh.make_mesh(jax.devices()[:n], axes=axes).shape)
    for n, k in ((12, 3), (16, 2), (30, 3), (7, 2), (64, 3)):
        assert pmesh._factor(n, k) == jmesh._factor(n, k)


def test_make_mesh_default_and_errors():
    """``make_mesh()`` takes every CUDA device and raises without a card,
    like every entry point of the port; a wrong shape is a ValueError, a
    device may repeat, and anything else given as a mesh is a TypeError."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: make_mesh() takes its devices")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_mesh()
    with pytest.raises(ValueError):
        parallel.make_mesh([CPU] * 8, axes=("rx", "tx"), shape=(3, 2))
    m = parallel.make_mesh(["cpu", "cpu"], axes=("rx",))
    assert m.shape == {"rx": 2} and all(d == CPU for d in m.devices.flat)
    x, pi, pr, pv, nv, t0 = das_problem()
    calls = (
        lambda mesh: parallel.das_sharded(mesh, x, pi, pr, pv, nv, t0, CINV, **PW),
        lambda mesh: parallel.das_sharded_pallas(mesh, x, pi, pr, pv, nv, t0, CINV, **PW),
        lambda mesh: parallel.das_lut_sharded_pallas(mesh, x, np.zeros((36, 8)),
                                                     np.zeros((36, 4)), t0, fs=4e6),
        lambda mesh: parallel.refocus_op_sharded(mesh, np.zeros((2, 2)), np.eye(2), T=8,
                                                 fs=1e6),
        lambda mesh: parallel.focus_tx_freq_sharded(mesh, x, np.zeros((4, 4)), np.eye(4),
                                                    fs=1e6))
    for call in calls:
        with pytest.raises(TypeError):
            call(jax_mesh((2,), ("rx",)))  # a JAX mesh is not the port's
        with pytest.raises(TypeError):
            call(object())


# ----------------------------------------------------------- das_sharded
@pytest.mark.parametrize("shape", [(1, 4, 2), (2, 2, 2), (1, 1, 8)])
def test_das_sharded_matches_single(shape):
    x, pi, pr, pv, nv, t0 = das_problem(F=4)
    ref = das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, fs=10e6, tx_model="plane")
    got = parallel.das_sharded(port_mesh(shape, ("frame", "rx", "tx")), x, pi, pr, pv, nv,
                               t0, CINV, fs=10e6, tx_model="plane")
    assert got.device == CPU and rel(got, ref) < TOL
    jref = jmesh.das_sharded(jax_mesh(shape, ("frame", "rx", "tx")), x, pi, pr, pv, nv, t0,
                             CINV, fs=10e6, tx_model="plane")
    assert rel(got, jref) < TOL


@pytest.mark.parametrize("keep", [dict(keep_rx=True), dict(keep_tx=True),
                                  dict(keep_rx=True, keep_tx=True)])
def test_das_sharded_keep(keep):
    """keep_rx (``tests/test_parallel.py:50``), keep_tx and both: the kept
    axes gathered back, their padding cropped (M = 5 on a 2-wide tx axis)."""
    x, pi, pr, pv, nv, t0 = das_problem(M=5, F=2)
    ref = das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, fs=10e6, tx_model="plane", **keep)
    got = parallel.das_sharded(port_mesh((2, 2, 2), ("frame", "rx", "tx")), x, pi, pr, pv,
                               nv, t0, CINV, fs=10e6, tx_model="plane", **keep)
    assert rel(got, ref) < TOL
    jref = jmesh.das_sharded(jax_mesh((2, 2, 2), ("frame", "rx", "tx")), x, pi, pr, pv, nv,
                             t0, CINV, fs=10e6, tx_model="plane", **keep)
    assert rel(got, jref) < TOL


def test_das_sharded_with_apod():
    x, pi, pr, pv, nv, t0 = das_problem(F=2)
    ap = np.random.default_rng(0).uniform(0.5, 1.0, (36, 1, 1, 8, 4)).astype(np.float32)
    kw = dict(fs=10e6, tx_model="plane", apod=(ap,))
    ref = das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, **kw)
    got = parallel.das_sharded(port_mesh((2, 2, 2), ("frame", "rx", "tx")), x, pi, pr, pv,
                               nv, t0, CINV, **kw)
    assert rel(got, ref) < TOL
    jref = jmesh.das_sharded(jax_mesh((2, 2, 2), ("frame", "rx", "tx")), x, pi, pr, pv, nv,
                             t0, CINV, **kw)
    assert rel(got, jref) < TOL


def test_system_greens_das_on_mesh_smoke():
    """Simulate, then beamform on the mesh: das_sharded of the system's
    geometry against ``us.DAS`` (1e-3, as the JAX test)."""
    xdc = qt.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
    seq = qt.SequenceRadial(type="PW", angles=[0.0, 5.0], c0=1540.0)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, fs=12e6, scan=qt.ScanCartesian(
        x=np.linspace(-3e-3, 3e-3, 16), z=np.linspace(25e-3, 33e-3, 16)))
    chd = us.greens(qt.Scatterers(pos=[[0.0], [0.0], [29e-3]], c0=1540.0), device="cpu")
    pv, nv, model = us._tx_geometry()
    img = parallel.das_sharded(port_mesh((1, 4, 2), ("frame", "rx", "tx")), chd.data,
                               us._pixels(), us.rx.positions().T, pv, nv, chd.t0_host.reshape(-1),
                               CINV, fs=float(chd.fs), tx_model=model)
    ref = us.DAS(chd, device="cpu")
    assert rel(img.reshape(ref.shape), ref) < 1e-3


# ---------------------------------------------------- das_sharded_pallas
def test_das_sharded_pallas_parity():
    """The sharded K1 path on a 2 x 2 (rx, tx) mesh against the unsharded
    call and the JAX package's XLA das (``tests/test_parallel.py:152``)."""
    x, pi, pr, pv, nv, t0 = shard_problem(N=16, M=4)
    got = parallel.das_sharded_pallas(port_mesh((2, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                      CINV, im_shape=IM, **PW)
    assert got.shape == (2048, 1, 1)
    assert rel(got, k1(x, pi, pr, pv, nv, t0, method="linear")) < TOL
    assert rel(got, jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", **PW)) < TOL


def test_das_sharded_pallas_bf16pair():
    """'bf16pair' per shard: the unsharded call at the same precision (the
    same rounded taps) within 1e-4, the JAX package's float32 XLA das
    within the 2e-2 band (``tests/test_parallel.py:184``)."""
    x, pi, pr, pv, nv, t0 = shard_problem(N=16, M=4, seed=11)
    got = parallel.das_sharded_pallas(port_mesh((2, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                      CINV, im_shape=IM, precision="bf16pair", **PW)
    assert rel(got, k1(x, pi, pr, pv, nv, t0, method="linear", precision="bf16pair")) < TOL
    f32 = jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", **PW)
    assert rel(got, f32) < BAND


def test_das_sharded_pallas_cubic_nondivisible():
    """Cubic, N = 24 over 4 rx shards of 8 (the last one padding only)."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    got = parallel.das_sharded_pallas(port_mesh((4, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                      CINV, method="cubic", im_shape=IM, **PW)
    assert rel(got, k1(x, pi, pr, pv, nv, t0, method="cubic")) < TOL
    jref = jmesh.das_sharded_pallas(jax_mesh((4, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                    CINV, method="cubic", im_shape=IM, interpret=True, **PW)
    assert rel(got, jref) < TOL


def test_das_sharded_pallas_keep_rx():
    x, pi, pr, pv, nv, t0 = shard_problem()
    got = parallel.das_sharded_pallas(port_mesh((4, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                      CINV, keep_rx=True, im_shape=IM, **PW)
    assert got.shape == (2048, 24, 1)
    assert rel(got, k1(x, pi, pr, pv, nv, t0, method="linear", keep_rx=True)) < TOL
    assert rel(got, jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", keep_rx=True,
                         **PW)) < TOL


@pytest.mark.parametrize("kind", ["cohfac", "slsc"])
@pytest.mark.parametrize("iq", [False, True])
def test_das_sharded_pallas_post_coherence(kind, iq):
    """In-mesh coherence: each rx shard reduces its own band, slsc's lag
    pairs across a shard's end from the next shard's halo. N = 22 on a
    4-wide rx axis of 8-channel shards: padded channels and a last shard of
    padding only. Against the port's reductions of the unsharded keep_rx
    image, and the JAX package's reductions of its XLA keep_rx image."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    N = 22
    x, pr = x[:, :N], pr[:N]
    if iq:
        x = (x + 1j * x[::-1]).astype(np.complex64)
    lags = 3
    got = parallel.das_sharded_pallas(port_mesh((4, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                      CINV, im_shape=IM, post=kind, lags=lags, **PW)
    assert got.shape == (pi.shape[0],) and got.dtype == torch.float32
    brx = k1(x, pi, pr, pv, nv, t0, method="linear", keep_rx=True)[:, :, 0]
    want = cohfac(brx, axis=1).abs() if kind == "cohfac" else slsc(brx, axis=1, lags=lags).real
    tol = TOL if kind == "cohfac" else SLSC
    assert rel(got, want) < tol
    jbrx = np.asarray(jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", keep_rx=True,
                           **PW))[:, :, 0]
    jwant = np.real(np.asarray(jcohfac(jbrx, axis=1) if kind == "cohfac"
                               else jslsc(jbrx, axis=1, lags=lags)))
    assert rel(got, jwant) < tol


def test_das_sharded_pallas_post_slsc_interpret():
    """slsc with complex traces against the JAX package's interpret-mode
    sharded kernel with its own in-mesh reduction (the halo by
    ``ppermute``), default lags (N // 4 = 5, within the shard of 8)."""
    x, pi, pr, pv, nv, t0 = shard_problem(N=22, cplx=True)
    kw = dict(im_shape=IM, post="slsc", **PW)
    got = parallel.das_sharded_pallas(port_mesh((4, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                      CINV, **kw)
    jref = jmesh.das_sharded_pallas(jax_mesh((4, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                    CINV, interpret=True, **kw)
    assert rel(got, jref) < SLSC
    with pytest.raises(ValueError, match="shard width"):
        parallel.das_sharded_pallas(port_mesh((4, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                    CINV, lags=9, **kw)


@pytest.mark.parametrize("keep", ["keep_rx", "keep_tx"])
def test_das_sharded_pallas_keep_frames(keep):
    """keep_rx / keep_tx with a 'frame' mesh axis: the kept bands per frame
    shard, gathered back (``tests/test_parallel.py:314``, ``:336``)."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    x = np.stack([x, 3 * x - 1], axis=-1)
    got = parallel.das_sharded_pallas(port_mesh((2, 2, 2), ("frame", "rx", "tx")), x, pi, pr,
                                      pv, nv, t0, CINV, im_shape=IM, **{keep: True}, **PW)
    assert rel(got, k1(x, pi, pr, pv, nv, t0, method="linear", **{keep: True})) < TOL
    assert rel(got, jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", **{keep: True},
                         **PW)) < TOL


@pytest.mark.parametrize("keep", [{}, {"keep_rx": True}, {"keep_tx": True}])
def test_das_sharded_pallas_rank4_single_frame(keep):
    """A (T, N, M, F = 1) operand on a mesh with a frame axis: one frame
    shard holds the frame, the others replicate nothing
    (``tests/test_parallel.py:359``)."""
    x, pi, pr, pv, nv, t0 = shard_problem(N=16, M=4)
    x4 = x[..., None]
    got = parallel.das_sharded_pallas(port_mesh((2, 2, 2), ("frame", "rx", "tx")), x4, pi, pr,
                                      pv, nv, t0, CINV, im_shape=IM, **keep, **PW)
    ref = jdas(x4, pi, pr, pv, nv, t0, CINV, method="linear", **keep, **PW)
    assert rel(got, ref) < TOL


def test_das_sharded_pallas_plan_reuse():
    """The plan slices and uploads each shard's geometry once and applies to
    any number of frames (the port's counterpart of the JAX package's plan
    cache, ``tests/test_parallel.py:381``); the traces must match it."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    apply = parallel.das_sharded_pallas_plan(port_mesh((4, 2), ("rx", "tx")), pi, pr, pv, nv,
                                             t0, CINV, T=256, N=24, M=6, im_shape=IM, **PW)
    a1, a2 = apply(x), apply(torch.as_tensor(2 * x))
    assert rel(a2, 2 * a1) < TOL and rel(a1, k1(x, pi, pr, pv, nv, t0, method="linear")) < TOL
    with pytest.raises(ValueError):
        apply(x[:, :20])
    with pytest.raises(ValueError):
        apply(x[..., None])  # a plan of Fn = None


def test_das_sharded_pallas_plan_refusals():
    """The JAX package's refusals: an unknown precision and 'i8x4' (its scale
    is per call), keep_rx with keep_tx, post with keep_tx."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    mesh = port_mesh((4, 2), ("rx", "tx"))
    for kw in (dict(precision="i8x4"), dict(precision="bf16"), dict(keep_rx=True, keep_tx=True),
               dict(post="cohfac", keep_tx=True), dict(post="dmas")):
        with pytest.raises(ValueError):
            parallel.das_sharded_pallas(mesh, x, pi, pr, pv, nv, t0, CINV, **kw, **PW)
        with pytest.raises(ValueError):
            jmesh.das_sharded_pallas(jax_mesh((4, 2), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                     CINV, interpret=True, **kw, **PW)


def test_das_sharded_pallas_fused_apod():
    """Fused aperture growth per shard (its orientations sliced by rx shard)
    against the dense mask through the XLA das (``tests/test_parallel.py:440``);
    a Fused tx_scanline with one ``lat_tx`` a transmit and a dense weight
    over (N, M), each sliced by shard, against the unsharded call."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    N, M = pr.shape[0], pv.shape[0]
    mesh = port_mesh((4, 2), ("rx", "tx"))
    d = pi[:, None, 0] - pr[None, :, 0]
    z = pi[:, None, 2] - pr[None, :, 2]
    apd = (np.abs(z) > 2.0 * np.abs(d)).astype(np.float32).reshape(-1, 1, 1, N, 1)
    ori = np.stack([np.zeros(N), np.ones(N)]).astype(np.float32)
    got = parallel.das_sharded_pallas(mesh, x, pi, pr, pv, nv, t0, CINV, im_shape=IM,
                                      apod=(qt.Fused("aperture_growth", f=1.0),),
                                      orientations=ori, **PW)
    assert rel(got, jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", apod=(apd,),
                         **PW)) < TOL
    w = np.random.default_rng(4).uniform(0.5, 1.0, (1, 1, 1, N, M)).astype(np.float32)
    apod = (qt.Fused("tx_scanline", tol=3e-3, lat_tx=np.linspace(-9e-3, 9e-3, M)), w)
    got = parallel.das_sharded_pallas(mesh, x, pi, pr, pv, nv, t0, CINV, im_shape=IM,
                                      apod=apod, keep_tx=True, **PW)
    assert rel(got, k1(x, pi, pr, pv, nv, t0, method="linear", apod=apod, im_shape=IM,
                       keep_tx=True)) < TOL


def test_das_sharded_pallas_frames_iq_fmod():
    """Frames, IQ data and fmod on a (rx, tx, frame) mesh
    (``tests/test_parallel.py:466``); the traces stay complex64."""
    x, pi, pr, pv, nv, t0 = shard_problem(F=3, cplx=True)
    got = parallel.das_sharded_pallas(port_mesh((2, 2, 2), ("rx", "tx", "frame")), x, pi, pr,
                                      pv, nv, t0, CINV, fmod=2e5, im_shape=IM, **PW)
    assert got.dtype == torch.complex64 and got.shape == (2048, 1, 1, 3)
    assert rel(got, k1(x, pi, pr, pv, nv, t0, method="linear", fmod=2e5)) < TOL
    assert rel(got, jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", fmod=2e5, **PW)) < TOL


def test_das_sharded_pallas_single_axis_mesh():
    x, pi, pr, pv, nv, t0 = shard_problem(N=16, M=4)
    got = parallel.das_sharded_pallas(port_mesh((2,), ("rx",)), x, pi, pr, pv, nv, t0, CINV,
                                      im_shape=IM, **PW)
    assert rel(got, jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", **PW)) < TOL


def test_volumetric_sharded_das():
    """A 4 x 4 matrix probe's volume through the sharded K1 path
    (``tests/test_sweep.py:211``): the 3-D scan's pixels on a (2, 4) mesh."""
    rng = np.random.default_rng(11)
    xdc = qt.TransducerMatrix(numd=(4, 4), pitch2=(0.4e-3, 0.4e-3), fc=3e6)
    N = M = xdc.numel
    x = rng.standard_normal((256, N, M)).astype(np.float32)
    pr = xdc.positions().T.astype(np.float32)
    pv = np.zeros((M, 3), np.float32)
    nv = np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
    t0 = np.full(M, 2 * 5e-3 / 1540.0, np.float32)
    scan = qt.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 8), y=np.linspace(-4e-3, 4e-3, 4),
                            z=np.linspace(18e-3, 26e-3, 8))
    pi = scan.positions().reshape(3, -1).T.astype(np.float32)
    got = parallel.das_sharded_pallas(port_mesh((2, 4), ("rx", "tx")), x, pi, pr, pv, nv, t0,
                                      CINV, im_shape=tuple(scan.shape), **PW)
    assert rel(got, jdas(x, pi, pr, pv, nv, t0, CINV, method="linear", **PW)) < TOL


# ------------------------------------------------ das_lut_sharded_pallas
def lut_tables(pi, pr, nv):
    tau_rx = (np.linalg.norm(pi[:, None, :] - pr[None], axis=-1) / 1540.0).astype(np.float32)
    return tau_rx, (pi @ nv.T / 1540.0).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(keep_rx=True), dict(method="cubic")])
def test_das_lut_sharded_pallas(kw):
    """The sharded K2 path, summed, keep_rx and cubic, against the
    unsharded call, the XLA das_lut and (summed) JAX's interpret-mode
    sharded LUT kernel."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    tau_rx, tau_tx = lut_tables(pi, pr, nv)
    got = parallel.das_lut_sharded_pallas(port_mesh((4, 2), ("rx", "tx")), x, tau_rx, tau_tx,
                                          t0, fs=4e6, **kw)
    m = kw.get("method", "linear")
    keep = dict(keep_rx=kw.get("keep_rx", False))
    ref = das_cuda.das_lut_sum(torch.as_tensor(x), tau_rx, tau_tx, t0, fs=4e6, method=m, **keep)
    assert rel(got, ref) < TOL
    assert rel(got, jdas_lut(x, tau_rx, tau_tx, t0, fs=4e6, method=m, **keep)) < TOL
    if not kw:
        jref = jmesh.das_lut_sharded_pallas(jax_mesh((4, 2), ("rx", "tx")), x, tau_rx, tau_tx,
                                            t0, fs=4e6, interpret=True)
        assert rel(got, jref) < TOL


def test_das_lut_sharded_pallas_post_coherence():
    """In-mesh cohfac on the sharded K2 path (``tests/test_parallel.py:417``),
    against JAX's interpret-mode sharded LUT kernel with its own reduction."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    tau_rx, tau_tx = lut_tables(pi, pr, nv)
    got = parallel.das_lut_sharded_pallas(port_mesh((4, 2), ("rx", "tx")), x, tau_rx, tau_tx,
                                          t0, fs=4e6, im_shape=IM, post="cohfac")
    brx = das_lut(torch.as_tensor(x), tau_rx, tau_tx, t0, fs=4e6, method="linear",
                  keep_rx=True)[:, :, 0]
    assert rel(got, cohfac(brx, axis=1).abs()) < TOL
    jref = jmesh.das_lut_sharded_pallas(jax_mesh((4, 2), ("rx", "tx")), x, tau_rx, tau_tx,
                                        t0, fs=4e6, im_shape=IM, interpret=True, post="cohfac")
    assert rel(got, jref) < TOL


def test_das_lut_sharded_pallas_plan_reuse():
    """The LUT plan slices and uploads each shard's tables once
    (``tests/test_parallel.py:510``'s plan cache, as a kept plan)."""
    x, pi, pr, pv, nv, t0 = shard_problem()
    tau_rx, tau_tx = lut_tables(pi, pr, nv)
    apply = parallel.das_lut_sharded_pallas_plan(port_mesh((4, 2), ("rx", "tx")), tau_rx,
                                                 tau_tx, t0, fs=4e6, T=256, N=24, M=6)
    a1, a2 = apply(x), apply(2 * x)
    assert rel(a2, 2 * a1) < TOL
    assert rel(a1, jdas_lut(x, tau_rx, tau_tx, t0, fs=4e6, method="linear")) < TOL
    with pytest.raises(ValueError, match="i8x4"):
        parallel.das_lut_sharded_pallas_plan(port_mesh((4, 2), ("rx", "tx")), tau_rx, tau_tx,
                                             t0, fs=4e6, T=256, N=24, M=6, precision="i8x4")


# ------------------------------------------------- coherence_image(mesh=)
def coherence_system(mod):
    xdc = mod.TransducerArray(numel=8, pitch=0.3e-3, fc=3e6)
    return mod.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=mod.Sequence(type="FSA", numpulse=8),
        scan=mod.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8), z=np.linspace(18e-3, 22e-3, 8)),
        fs=12e6)


@pytest.mark.parametrize("post,lags", [("cohfac", None), ("slsc", 2)])
def test_coherence_image_mesh_matches_fallback(post, lags):
    """``us.coherence_image(mesh=)`` (``tests/test_coherence.py:101``): the
    in-mesh path against the port's two steps without a mesh (1e-4, 1e-3),
    and against the JAX package's mesh path (interpret mode) on the same
    traces, within its own test's 5e-3."""
    us = coherence_system(q)
    chd = us.greens(q.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0))
    ust, chdt = from_reference(us), from_reference(chd)
    got = ust.coherence_image(chdt, post=post, lags=lags, mesh=port_mesh((2, 1), ("rx", "tx")))
    assert got.shape == tuple(ust.scan.shape) and got.device == CPU
    ref = ust.coherence_image(chdt, post=post, lags=lags, device="cpu")
    assert rel(got, ref) < (TOL if post == "cohfac" else SLSC)
    jref = us.coherence_image(chd, post=post, lags=lags, precision="f32",
                              mesh=jax_mesh((2, 1), ("rx", "tx")))
    assert rel(got, jref) < 5e-3


def test_coherence_image_mesh_routes():
    """Eligible calls (Fused apodization, a scalar c0, 3-D traces, one of
    the four samplers) run in the mesh; the others run the two steps on
    the traces' device, as the JAX package's; a non-mesh is a TypeError."""
    us = coherence_system(qt)
    chd = us.greens(qt.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0), device="cpu")
    mesh = port_mesh((4, 2), ("rx", "tx"))
    fused = (qt.Fused("aperture_growth", f=1.0),)
    for kw in (dict(apod=fused), dict(post="slsc", method="lanczos3"),
               dict(apod=(us.ap_aperture_growth(f=1.0),)),       # dense: two steps
               dict(method="cubic2x"),                           # not a K1 sampler
               dict(c0=np.full(us.scan.shape, 1540.0))):         # a map: two steps
        got = us.coherence_image(chd, mesh=mesh, **kw)
        ref = us.coherence_image(chd, device="cpu", **kw)
        assert got.shape == ref.shape and rel(got, ref) < 1e-3, kw
    frames = chd.replace(data=torch.stack([chd.data, 2 * chd.data], -1))
    assert us.coherence_image(frames, mesh=mesh).shape == tuple(us.scan.shape) + (2,)
    with pytest.raises(TypeError):
        us.coherence_image(chd, mesh=object())
    with pytest.raises(ValueError):
        us.coherence_image(chd, mesh=mesh, precision="i8x4")


def _examples():
    """The ``Example:`` blocks of the mesh module's docstrings."""
    objs = [getattr(pmesh, name) for name in parallel.__all__]
    return [(o.__qualname__, textwrap.dedent(inspect.getdoc(o).split("Example:", 1)[1]))
            for o in objs if "Example:" in (inspect.getdoc(o) or "")]


@pytest.mark.parametrize("name,code", _examples(), ids=lambda v: v[:32])
def test_docstring_examples_run(name, code):
    exec(compile(code, name, "exec"), {})
