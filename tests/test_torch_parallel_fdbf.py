"""The port's sharded frequency-domain functions on the CPU
(``qups_tpu_torch/parallel/mesh.py``): ``bf_adjoint_sharded`` (the pixels
over every mesh axis, the spectra computed once and copied, K4 per shard;
its plain version on the CPU), ``refocus_op_sharded`` and
``refocus_sharded`` (the bins, then the receive channels, over every axis),
``focus_tx_freq_sharded`` (the receive channels) and ``migration_sharded``
(the plane-wave angles); and a checkpoint of a sharded result.

The counterparts of ``tests/test_parallel.py``'s adjoint, refocus, focus
and migration tests, ``tests/test_fdbf.py:194`` and
``tests/test_checkpoint.py:22`` on their mesh shapes (k
``torch.device("cpu")`` entries for k virtual CPU devices). Each sharded
result is held to the port's own unsharded call and to the JAX package's
sharded function on the same inputs (``bf_adjoint_sharded`` in interpret
mode, three cases).

Tolerances, max|got - ref| against max|ref|: 1e-4, the float32 standard,
against the port's unsharded calls (the adjoint in 'bf16' too: the same
rounded operands; keep_rx bit for bit, as each pixel's sum is its own; the
operator and the decode 1e-5, as ``tests/test_parallel.py``); the adjoint
against the JAX package's 2e-3 (``tests/test_torch_fdbf.py``'s limit: JAX's
direct phases against the port's ``2 pi frac(f tau)`` phasors, up to 3e-4
rad); refocus, focus and migration against the JAX package's 1e-4 (the
migration run op by op under ``jax.disable_jit``, as
``tests/test_torch_refocus.py`` explains).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from qups_tpu.parallel import mesh as jmesh  # noqa: E402
from qups_tpu_torch import parallel  # noqa: E402
from qups_tpu_torch.io import load_checkpoint, save_checkpoint  # noqa: E402
from qups_tpu_torch.ops import fdbf  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-4
ADJ_JAX = 2e-3


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


def adjoint_problem(seed=11, T=128, N=8, M=6, V=9, I=83):
    """``tests/test_parallel.py:591``'s: I = 83 pixels, non-divisible by 8."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, V)).astype(np.float32)
    tau_rx = rng.uniform(0, 2e-6, (I, N)).astype(np.float32)
    tau_tx = rng.uniform(0, 2e-6, (I, M)).astype(np.float32)
    del_tx = rng.uniform(0, 3e-7, (M, V)).astype(np.float32)
    apod = rng.standard_normal((M, V)).astype(np.float32)
    t0 = rng.uniform(0, 1e-6, (V,)).astype(np.float32)
    t0o = rng.uniform(0, 1e-7, (V,)).astype(np.float32)
    return x, tau_rx, tau_tx, del_tx, apod, t0, t0o


BINS = np.arange(5, 17, dtype=np.int32)


@pytest.mark.parametrize("mode", ["sum", "rx", "tx"])
def test_bf_adjoint_sharded_matches_single(mode):
    """Pixel-sharded adjoint on a (2, 4) mesh in 'f32' against the
    unsharded plain adjoint and JAX's interpret-mode sharded kernel."""
    args = adjoint_problem()
    kw = {"keep_rx": mode == "rx", "keep_tx": mode == "tx"}
    got = parallel.bf_adjoint_sharded(port_mesh((2, 4), ("rx", "tx")), *args, BINS, fs=40e6,
                                      fmod=1e6, precision="f32", **kw)
    ref = fdbf.bf_adjoint(torch.as_tensor(args[0]), *args[1:], BINS, fs=40e6, fmod=1e6,
                          precision="f32", **kw)
    assert got.dtype == torch.complex64 and rel(got, ref) < TOL
    if mode == "rx":  # each pixel's sum is its own: the same products, bit for bit
        assert torch.equal(got, ref)
    jref = jmesh.bf_adjoint_sharded(jax_mesh((2, 4), ("rx", "tx")), *args, BINS, fs=40e6,
                                    fmod=1e6, precision="f32", BI=8, interpret=True, **kw)
    assert rel(got, jref) < ADJ_JAX


@pytest.mark.parametrize("mode", ["sum", "rx"])
def test_bf_adjoint_sharded_bf16(mode):
    """'bf16' operands: the sharded adjoint rounds the same operands as the
    unsharded one."""
    args = adjoint_problem(seed=3, I=50)
    kw = {"keep_rx": mode == "rx"}
    got = parallel.bf_adjoint_sharded(port_mesh((4, 2), ("rx", "tx")), *args, BINS, fs=40e6,
                                      precision="bf16", **kw)
    ref = fdbf.bf_adjoint(torch.as_tensor(args[0]), *args[1:], BINS, fs=40e6,
                          precision="bf16", **kw)
    assert rel(got, ref) < TOL


def test_bf_adjoint_sharded_bin_padding_and_empty():
    """``tests/test_fdbf.py:194``: -1 bins are skipped, an empty set gives a
    zero image of the unsharded shape, an unknown precision raises."""
    x, tau_rx, tau_tx, del_tx, apod, t0, _ = adjoint_problem(seed=5, T=64, N=4, M=4, V=4, I=24)
    args = (x, tau_rx, tau_tx, del_tx, apod, t0, t0)
    mesh = port_mesh((2, 4), ("rx", "tx"))
    padded = np.array([5, 6, 7, -1, -1], np.int32)
    got = parallel.bf_adjoint_sharded(mesh, *args, padded, fs=40e6, precision="f32")
    assert rel(got, parallel.bf_adjoint_sharded(mesh, *args, padded[:3], fs=40e6,
                                                precision="f32")) == 0.0
    assert rel(got, fdbf.bf_adjoint(torch.as_tensor(x), *args[1:], padded, fs=40e6)) < TOL
    empty = parallel.bf_adjoint_sharded(mesh, *args, np.zeros(0, np.int32), fs=40e6)
    assert empty.shape == (24,) and not empty.abs().any()
    with pytest.raises(ValueError):
        parallel.bf_adjoint_sharded(mesh, *args, padded, fs=40e6, precision="fp32")
    with pytest.raises(ValueError):
        parallel.bf_adjoint_sharded(mesh, *args, padded, fs=40e6, keep_rx=True, keep_tx=True)


# ------------------------------------------------------------------ refocus
def test_refocus_sharded_matches_single():
    """Bin-sharded operator and rx-sharded decode (N = 10 on 8 devices)
    against the unsharded ones and JAX's sharded ones."""
    rng = np.random.default_rng(7)
    T, N, M, V = 96, 10, 4, 6
    x = rng.standard_normal((T, N, V)).astype(np.float32)
    tau = rng.uniform(0, 1e-6, (M, V)).astype(np.float32)
    apd = np.ones((M, V), np.float32)
    t0 = np.linspace(0, 1e-6, V).astype(np.float32)
    mesh, jm = port_mesh((4, 2), ("rx", "tx")), jax_mesh((4, 2), ("rx", "tx"))
    Hi0 = fdbf.refocus_op(tau, apd, T=T, fs=8e6, device="cpu")
    Hi1 = parallel.refocus_op_sharded(mesh, tau, apd, T=T, fs=8e6)
    assert rel(Hi1, Hi0) <= 1e-5
    assert rel(Hi1, jmesh.refocus_op_sharded(jm, tau, apd, T=T, fs=8e6)) < TOL
    y0, t0m0 = fdbf.refocus_apply(x, Hi0, t0, fs=8e6, device="cpu")
    y1, t0m1 = parallel.refocus_sharded(mesh, x, tau, apd, t0, fs=8e6)
    assert t0m0 == t0m1 and rel(y1, y0) <= 1e-5
    jy, jt0m = jmesh.refocus_sharded(jm, x, tau, apd, t0, fs=8e6)
    assert float(jt0m) == t0m1 and rel(y1, jy) < TOL
    y2, _ = parallel.refocus_sharded(mesh, x, tau, apd, t0, fs=8e6, Hi=Hi0)
    assert rel(y2, y0) <= 1e-5


def test_focus_tx_freq_sharded_matches_single():
    """Rx-sharded transmit synthesis with trailing frame dims."""
    rng = np.random.default_rng(8)
    xf = rng.standard_normal((64, 10, 4, 3)).astype(np.float32)
    t2 = rng.uniform(0, 1e-6, (4, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    got = parallel.focus_tx_freq_sharded(port_mesh((2, 4), ("rx", "tx")), xf, t2, w, fs=8e6)
    assert got.shape == (64, 10, 5, 3)
    assert rel(got, fdbf.focus_tx_freq(torch.as_tensor(xf), t2, w, fs=8e6)) <= 1e-5
    jref = jmesh.focus_tx_freq_sharded(jax_mesh((2, 4), ("rx", "tx")), xf, t2, w, fs=8e6)
    assert rel(got, jref) < TOL


@pytest.mark.parametrize("keep_tx", [False, True])
def test_migration_sharded_matches_single(keep_tx):
    """Angle-sharded Stolt migration, 5 angles on 4 devices."""
    rng = np.random.default_rng(9)
    T, N, M = 128, 16, 5
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    th = tuple(np.linspace(-8.0, 8.0, M))
    del_tx = rng.uniform(0, 1e-7, (N, M)).astype(np.float32)
    t0 = np.linspace(0, 1e-6, M).astype(np.float32)
    kw = dict(fs=8e6, c0=1540.0, pitch=0.3e-3, keep_tx=keep_tx)
    got = parallel.migration_sharded(port_mesh((4,), ("tx",)), x, t0, del_tx, th, **kw)
    ref = fdbf.stolt_migration(x, t0, del_tx, th, device="cpu", **kw)
    assert got.shape == ref.shape and rel(got, ref) < TOL
    if keep_tx:  # each angle's image against the JAX package's (16 s op by op)
        with jax.disable_jit():
            jri = np.asarray(jmesh.migration_sharded(jax_mesh((4,), ("tx",)), x, t0, del_tx,
                                                     th, out="ri", **kw))
        assert rel(got, jri[..., 0] + 1j * jri[..., 1]) < TOL


# ------------------------------------------------------------- checkpoint
def test_checkpoint_sharded_roundtrip(tmp_path):
    """``tests/test_checkpoint.py:22``: a result sharded over a 2-device mesh
    saved and restored onto the mesh's device (``like=``), and without a
    template onto the host."""
    mesh = port_mesh((2,), ("rx",))
    x = parallel.focus_tx_freq_sharded(mesh, np.arange(32.0, dtype=np.float32).reshape(4, 8, 1),
                                       np.zeros((1, 1)), np.ones((1, 1)), fs=1e6)
    p = str(tmp_path / "ckpt_sharded.pt")
    save_checkpoint(p, {"chd": x})
    back = load_checkpoint(p, like={"chd": torch.empty(0, device=mesh.devices.flat[0])})
    assert back["chd"].device == mesh.devices.flat[0] and torch.equal(back["chd"], x)
    assert torch.equal(load_checkpoint(p)["chd"], x.cpu())
