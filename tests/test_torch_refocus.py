"""The port's REFoCUS decoding and Stolt migration against qups_tpu, on the
CPU: refocus_op (tikhonov, adjoint, pinv; gamma default and 0),
refocus_apply, the system decode round trip and its operator cache,
stolt_migration over keep_tx, the jacobian and the samplers, and
bfMigration (the PSF on us.scan, the native grid), each with 2-frame data
held against JAX one frame at a time (the JAX functions take no frame dims).

Tolerances: max|port - JAX| < 1e-4 x max|JAX|, the float32 standard, for
every comparison (measured: refocus_op 3e-6 to 4e-6, refocus_apply 8e-7,
stolt_migration 6e-7, bfMigration 1.4e-6, the round trip below 2e-5). The
Stolt and bfMigration comparisons run the JAX functions op by op
(``jax.disable_jit``), as XLA runs each operation alone: under ``jit`` XLA
folds and fuses the remap index ``kkz`` and rounds it differently, and the
remap is ill-conditioned in float32. At bfMigration's PSF system the
spectrum turns by ~2.9 rad a bin (an echo at 39 us after the leading
zeros, 2048 bins at 24 MHz), so a few roundings of kkz near bin 1000
(1.2e-4 bins each) move the image by 1.8e-3 of its peak: jitted JAX is
that far from op-by-op JAX, and the port is 1.4e-6 from the latter. On
white-noise traces jit also rounds the bin f = -fs/2, kx = 0 to -1.8e-6
instead of its exact 0, off the interpolant's domain, and drops that row.
"""
import inspect
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import qups_tpu as q  # noqa: E402
from qups_tpu.ops import fdbf as jfdbf  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch import system as tsystem  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import fdbf  # noqa: E402

C0 = 1540.0
TARGET = np.array([0.0, 0.0, 30e-3])
TOL = 1.1e-3  # the PSF bound of the JAX package's tests [m]
F32 = 1e-4


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def hadamard(n):
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


def encoding(M=8, V=12, seed=2):
    rng = np.random.default_rng(seed)
    tau = rng.uniform(-1e-6, 1e-6, (M, V)).astype(np.float32)
    apd = rng.standard_normal((M, V)).astype(np.float32)
    return tau, apd


@pytest.mark.parametrize("gamma", [None, 0.0])
@pytest.mark.parametrize("method", ["tikhonov", "adjoint", "pinv"])
def test_refocus_op_matches_jax(method, gamma):
    tau, apd = encoding()
    ref = jfdbf.refocus_op(tau, apd, T=64, fs=20e6, gamma=gamma, method=method)
    got = fdbf.refocus_op(tau, apd, T=64, fs=20e6, gamma=gamma, method=method, device="cpu")
    assert got.dtype == torch.complex64 and got.shape == (64, 8, 12)
    assert rel(got, ref) < F32


def test_refocus_op_explicit_frequencies():
    """``f=`` replaces the fftfreq grid, as in the JAX package."""
    tau, apd = encoding()
    f = np.linspace(1e6, 5e6, 7)
    ref = jfdbf.refocus_op(tau, apd, T=64, fs=20e6, f=f)
    got = fdbf.refocus_op(tau, apd, T=64, fs=20e6, f=f, device="cpu")
    assert rel(got, ref) < F32


def test_spectral_norm_matches_jax():
    """The norm of each bin equals JAX's ``matrix_norm(H, ord=2)`` to 1e-4
    relative, both orientations of H, and a rank-1 bin (a plane-wave
    encoding at f = 0)."""
    rng = np.random.default_rng(4)
    for V, M in ((12, 8), (8, 12)):
        H = (rng.standard_normal((5, V, M)) + 1j * rng.standard_normal((5, V, M))
             ).astype(np.complex64)
        H[0] = np.outer(rng.standard_normal(V), rng.standard_normal(M))
        ref = np.asarray(jax.numpy.linalg.matrix_norm(H, ord=2))
        got = fdbf.spectral_norm(torch.as_tensor(H)).numpy()
        assert np.abs(got - ref).max() / ref.max() < 1e-4


def test_refocus_op_cleans_nan_like_jax():
    """A zero apodization makes every bin singular: the operator is
    cleaned to finite values as ``jnp.nan_to_num`` cleans it."""
    tau, apd = encoding()
    apd[:] = 0
    ref = np.asarray(jfdbf.refocus_op(tau, apd, T=16, fs=20e6, method="adjoint"))
    got = fdbf.refocus_op(tau, apd, T=16, fs=20e6, method="adjoint", device="cpu").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)


def test_refocus_apply_frames_match_jax():
    tau, apd = encoding()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 3, 12, 2)).astype(np.float32)
    t0 = rng.uniform(0, 1e-6, 12).astype(np.float32)
    Hi = jfdbf.refocus_op(tau, apd, T=64, fs=20e6)
    got, t0min = fdbf.refocus_apply(torch.as_tensor(x), torch.as_tensor(np.array(Hi)),
                                    t0, fs=20e6, device="cpu")
    assert got.shape == (64, 3, 8, 2)
    for f in range(2):
        ref, rt0 = jfdbf.refocus_apply(x[..., f], Hi, t0, fs=20e6)
        assert rel(got[..., f], ref) < F32
        assert t0min == float(rt0)


def test_refocus_function_matches_jax():
    tau, apd = encoding()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, 3, 12)).astype(np.float32)
    ref, _ = jfdbf.refocus(x, tau, apd, 0.0, fs=20e6, method="pinv")
    got, _ = fdbf.refocus(x, tau, apd, 0.0, fs=20e6, method="pinv", device="cpu")
    assert rel(got, ref) < F32


def _fsa_systems(numel=16):
    xdc = q.TransducerArray(numel=numel, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=numel, c0=C0),
        scan=q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 16),
                             z=np.linspace(25e-3, 35e-3, 16)), fs=24e6)
    return us, from_reference(us)


@pytest.fixture(scope="module")
def roundtrip():
    """FSA echoes of one target (JAX greens) and their Hadamard encoding
    (JAX focusTx), as host arrays for both packages."""
    us, ust = _fsa_systems()
    fsa = us.greens(q.Scatterers(pos=TARGET.reshape(3, 1), c0=C0))
    H = hadamard(16)
    seq_enc = q.Sequence(type="FSA", numpulse=16, c0=C0, apd=H, del_=np.zeros((16, 16)))
    enc = us.focusTx(fsa, seq_enc)
    return us, ust, fsa, enc, seq_enc


def test_refocus_roundtrip_matches_jax(roundtrip):
    """After ``tests/test_fdbf.py:43``: FSA -> Hadamard -> refocus(gamma=0)
    recovers the FSA within 0.05 of its peak, and the port's decode equals
    JAX's on the same encoded traces; 2 frames, each JAX's decode."""
    us, ust, fsa, enc, seq_enc = roundtrip
    ref = us.refocus(enc, seq_enc, gamma=0.0)
    x = np.asarray(enc.data)
    x2 = np.stack([x, -0.5 * x], -1)
    chd = qt.ChannelData(data=x2, fs=enc.fs, t0=enc.t0_host)
    dec = ust.refocus(chd, from_reference(seq_enc), gamma=0.0, device="cpu")
    assert dec.data.shape == (x.shape[0], 16, 16, 2)
    assert np.isclose(dec.t0_host[0], ref.t0_host[0])
    assert rel(dec.data[..., 0], ref.data) < F32
    assert rel(dec.data[..., 1], -0.5 * np.asarray(ref.data)) < F32
    x0 = np.asarray(fsa.data)
    assert np.abs(dec.data[..., 0].numpy() - x0).max() / np.abs(x0).max() < 0.05


def test_refocus_default_gamma_matches_jax(roundtrip):
    """The default gamma puts the spectral norm on the decode's path."""
    us, ust, _, enc, seq_enc = roundtrip
    ref = us.refocus(enc, seq_enc)
    dec = ust.refocus(from_reference(enc), from_reference(seq_enc), device="cpu")
    assert rel(dec.data, ref.data) < F32


def test_refocus_op_cache_reused():
    """After ``tests/test_fdbf.py:116``: the second decode takes the cached
    operator (one entry, keyed also by device), and decoding is linear."""
    ust = _fsa_systems(numel=32)[1]
    seq = qt.Sequence(type="FSA", numpulse=32, c0=C0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 3, 32)).astype(np.float32)
    chd = qt.ChannelData(data=x, fs=ust.fs, t0=0.0)
    tsystem._REFOCUS_OP_CACHE.clear()
    d1 = ust.refocus(chd, seq, gamma=0.0, device="cpu")
    assert len(tsystem._REFOCUS_OP_CACHE) == 1
    assert list(tsystem._REFOCUS_OP_CACHE)[0][-1] == "cpu"
    d2 = ust.refocus(chd.replace(data=torch.as_tensor(2.0 * x)), seq, gamma=0.0, device="cpu")
    assert len(tsystem._REFOCUS_OP_CACHE) == 1
    np.testing.assert_allclose(d2.data.abs().numpy(), 2.0 * d1.data.abs().numpy(),
                               rtol=1e-5, atol=1e-6)
    tsystem._REFOCUS_OP_CACHE.clear()


def test_refocus_op_cache_bounded_by_bytes(monkeypatch):
    """FIFO eviction by bytes: with room for one operator, a second decode
    (another T) evicts the first."""
    ust = _fsa_systems(numel=4)[1]
    seq = qt.Sequence(type="FSA", numpulse=4, c0=C0)
    tsystem._REFOCUS_OP_CACHE.clear()
    monkeypatch.setattr(tsystem, "_REFOCUS_OP_CACHE_MAX_BYTES", 64 * 4 * 4 * 8)
    for T in (64, 32):
        ust.refocus(qt.ChannelData(data=np.ones((T, 2, 4), np.float32), fs=ust.fs),
                    seq, device="cpu")
    assert [k[1] for k in tsystem._REFOCUS_OP_CACHE] == [32]
    tsystem._REFOCUS_OP_CACHE.clear()


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic", "lanczos3"])
@pytest.mark.parametrize("jacobian", [True, False])
@pytest.mark.parametrize("keep_tx", [False, True])
def test_stolt_migration_matches_jax(keep_tx, jacobian, method):
    rng = np.random.default_rng(7)
    T, N, M = 128, 16, 3
    x = rng.standard_normal((T, N, M, 2)).astype(np.float32)
    dl = rng.uniform(0, 1e-6, (N, M)).astype(np.float32)
    kw = dict(fs=20e6, c0=C0, pitch=3e-4, keep_tx=keep_tx, jacobian=jacobian, method=method,
              nfft=(256, 32), fmod=1e6)
    got = fdbf.stolt_migration(x, 1e-6, dl, (-5.0, 0.0, 5.0), device="cpu", **kw)
    assert got.shape == (T, N, M if keep_tx else 1, 2)
    for f in range(2):
        with jax.disable_jit():
            ref = jfdbf.stolt_migration(x[..., f], 1e-6, dl, (-5.0, 0.0, 5.0), **kw)
        assert rel(got[..., f], ref) < F32


def test_stolt_migration_gamma_override_matches_jax():
    """``gamma (M,)`` in place of the angles' alignment factors, and the
    default FFT sizes (T, N)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((96, 12, 2)).astype(np.float32)
    g = np.array([0.05, -0.03], np.float32)
    kw = dict(fs=20e6, c0=C0, pitch=3e-4, keep_tx=True, gamma=g)
    got = fdbf.stolt_migration(x, np.array([0.0, 2e-7]), np.zeros((12, 2)), (0.0, 0.0),
                               device="cpu", **kw)
    with jax.disable_jit():
        ref = jfdbf.stolt_migration(x, np.array([0.0, 2e-7]), np.zeros((12, 2)), (0.0, 0.0),
                                    **kw)
    assert rel(got, ref) < F32


def _pw_systems(angles):
    xdc = q.TransducerArray(numel=32, pitch=0.3e-3, fc=3e6)
    scan = q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 41), z=np.linspace(25e-3, 35e-3, 41))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=q.SequenceRadial(type="PW", angles=angles,
                                                                 c0=C0),
                            scan=scan, fs=24e6)
    chd = us.greens(q.Scatterers(pos=TARGET.reshape(3, 1), c0=C0))
    return us, from_reference(us), chd


def test_bf_migration_psf_matches_jax():
    """After ``tests/test_fdbf.py:75``: the resampled image equals JAX's and
    peaks within 1.1 mm of the target; 2 frames, each JAX's image."""
    us, ust, chd = _pw_systems([0.0])
    with jax.disable_jit():
        ref, _ = us.bfMigration(chd)
    x = np.asarray(chd.data)
    chd2 = qt.ChannelData(data=np.stack([x, 2.0 * x], -1), fs=chd.fs, t0=chd.t0_host)
    b, _ = ust.bfMigration(chd2, device="cpu")
    assert b.shape == tuple(ust.scan.shape) + (1, 1, 2)
    assert rel(b[..., 0], ref) < F32
    assert rel(b[..., 1], 2.0 * np.asarray(ref)) < F32
    bm = b[..., 0].abs().squeeze().numpy()
    i, j = np.unravel_index(np.argmax(bm), bm.shape)
    p = ust.scan.positions()[:, i, j, 0]
    assert abs(p[0] - TARGET[0]) < TOL and abs(p[2] - TARGET[2]) < TOL, p


@pytest.mark.parametrize("keep_tx", [False, True])
def test_bf_migration_native_grid_matches_jax(keep_tx):
    """After ``tests/test_fdbf.py:87``: the native image and its grid equal
    JAX's, its peak near the target."""
    us, ust, chd = _pw_systems([0.0, 5.0])
    with jax.disable_jit():
        ref, rscan = us.bfMigration(chd, resample=False, keep_tx=keep_tx)
    b, bscan = ust.bfMigration(from_reference(chd), resample=False, keep_tx=keep_tx,
                               device="cpu")
    assert rel(b, ref) < F32
    for ax in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(bscan, ax), getattr(rscan, ax), rtol=0, atol=1e-12)
    bm = b.abs().sum(2).numpy()
    iz, ix = np.unravel_index(bm.argmax(), bm.shape)
    assert abs(bscan.z[iz] - TARGET[2]) < TOL and abs(bscan.x[ix] - TARGET[0]) < TOL


def test_bf_migration_varying_t0_matches_jax():
    """A t0 that varies by transmit is rectified first, as in JAX."""
    us, ust, chd = _pw_systems([-4.0, 4.0])
    t0 = chd.t0_host + np.array([0.0, 3e-7])
    with jax.disable_jit():
        ref, _ = us.bfMigration(chd.replace(t0=t0), keep_tx=True)
    b, _ = ust.bfMigration(qt.ChannelData(data=np.asarray(chd.data), fs=chd.fs, t0=t0),
                           keep_tx=True, device="cpu")
    assert rel(b, ref) < F32


def test_bf_migration_rejects_other_sequences():
    ust = _fsa_systems()[1]
    with pytest.raises(ValueError):
        ust.bfMigration(qt.ChannelData(data=np.zeros((8, 16, 16), np.float32)), device="cpu")


def test_entry_points_default_to_the_card():
    """Without ``device=``, each entry point asks for the CUDA device and,
    on a machine with none, raises naming ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points run there")
    ust = _fsa_systems(numel=4)[1]
    chd = qt.ChannelData(data=np.ones((16, 4, 4), np.float32), fs=ust.fs)
    tau, apd = encoding()
    calls = (lambda: ust.refocus(chd),
             lambda: ust.replace(seq=qt.SequenceRadial(type="PW", angles=[0.0])).bfMigration(chd),
             lambda: fdbf.refocus_op(tau, apd, T=16, fs=1e7),
             lambda: fdbf.refocus_apply(np.ones((16, 2, 12), np.float32),
                                        torch.zeros(16, 8, 12, dtype=torch.complex64), 0.0,
                                        fs=1e7),
             lambda: fdbf.refocus(np.ones((16, 2, 12), np.float32), tau, apd, 0.0, fs=1e7),
             lambda: fdbf.stolt_migration(np.ones((16, 4, 1), np.float32), 0.0,
                                          np.zeros((4, 1)), (0.0,), fs=1e7, c0=C0, pitch=3e-4))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _examples():
    objs = (fdbf.refocus, qt.UltrasoundSystem.refocus, qt.UltrasoundSystem.bfMigration)
    return [(o.__qualname__, textwrap.dedent(inspect.getdoc(o).split("Example:", 1)[1]))
            for o in objs]


@pytest.mark.parametrize("name,code", _examples(), ids=lambda v: v[:32])
def test_docstring_examples_run(name, code):
    exec(compile(code, name, "exec"), {})
