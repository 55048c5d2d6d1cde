"""Transmit synthesis in the port against qups_tpu: the samplers interpd,
wsinterpd and wsinterpd2, ChannelData.sample / sample2sep, and
UltrasoundSystem.focusTx to plane-wave and focused sequences with the
time-domain ('cubic') and frequency-domain ('freq') methods, including the
t0 that focusTx shifts and that DAS(bsize) slices per transmit. Tolerance:
max|port - JAX| < 1e-4 * max|JAX| (float32 on both sides)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
from qups_tpu.ops import interp as jinterp  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import interp  # noqa: E402

TOL = 1e-4
TARGET = np.array([0.0, 0.0, 20e-3])


def close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() < tol * np.abs(ref).max()


def traces(T=64, B=(3, 4), seed=30, cplx=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T,) + B).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    return x


@pytest.mark.parametrize("method", interp.METHODS)
def test_interpd_matches_reference(method):
    x = traces()
    tau = np.random.default_rng(31).uniform(-2, 66, (20, 3, 1)).astype(np.float32)
    close(interp.interpd(torch.as_tensor(x), torch.as_tensor(tau), method=method),
          jinterp.interpd(x, tau, method=method))


@pytest.mark.parametrize("method", interp.METHODS)
def test_wsinterpd_matches_reference(method):
    """Weights, a summed dim and the omega remodulation, complex traces."""
    x = traces(cplx=True)
    rng = np.random.default_rng(32)
    tau = rng.uniform(0, 63, (20, 3, 4)).astype(np.float32)
    w = rng.uniform(size=(1, 3, 4)).astype(np.float32)
    kw = dict(w=w, sdim=1, omega=0.3, method=method)
    close(interp.wsinterpd(torch.as_tensor(x), torch.as_tensor(tau), **kw),
          jinterp.wsinterpd(x, tau, **kw))


@pytest.mark.parametrize("method", interp.METHODS)
@pytest.mark.parametrize("M", [3, 7])
def test_wsinterpd2_matches_reference(method, M):
    """The separable sum over a transmit dim: dense (M <= 4) and looped."""
    x = traces(B=(5, M))
    rng = np.random.default_rng(33)
    t1 = rng.uniform(0, 40, (64, 1, 1, 1)).astype(np.float32)
    t2 = rng.uniform(0, 20, (1, 1, M, 2)).astype(np.float32)
    w = rng.uniform(size=(1, 1, M, 2)).astype(np.float32)
    kw = dict(w=w, sdim=2, method=method)
    ref = jinterp.wsinterpd2(x[..., None], t1, t2, **kw)
    close(interp.wsinterpd2(torch.as_tensor(x[..., None]), torch.as_tensor(t1),
                            torch.as_tensor(t2), **kw), ref)


def test_channel_data_sample_matches_reference():
    x = traces(T=128, B=(4, 3), cplx=True)
    t0 = np.array([1e-6, 1.2e-6, 0.9e-6], np.float32)
    chd = q.ChannelData(data=x, fs=20e6, t0=t0)
    tau = np.random.default_rng(34).uniform(1e-6, 7e-6, (30, 4, 3)).astype(np.float32)
    kw = dict(method="cubic", sdim=2, fmod=3e6)
    close(from_reference(chd).sample(tau, **kw), chd.sample(tau, **kw))
    kw = dict(method="freq", sdim=2, fmod=3e6)  # the Fourier interpolant
    close(from_reference(chd).sample(tau, **kw), chd.sample(tau, **kw))


@pytest.mark.parametrize("T", [16, 200])
def test_sample2sep_matches_reference(T):
    """t0 (per transmit) folds into the smaller delay tensor: tau1 for short
    traces, tau2 for long ones."""
    x = traces(T=T, B=(4, 6))
    chd = q.ChannelData(data=x, fs=20e6, t0=np.linspace(1e-6, 2e-6, 6).astype(np.float32))
    rng = np.random.default_rng(35)
    t1 = (1e-6 + np.arange(T, dtype=np.float32) / 20e6).reshape(T, 1, 1)
    t2 = rng.uniform(0, 1e-6, (1, 4, 6)).astype(np.float32)
    w = rng.uniform(size=(1, 1, 6)).astype(np.float32)
    kw = dict(method="linear", w=w, sdim=2)
    close(from_reference(chd).sample2sep(t1, t2, **kw), chd.sample2sep(t1, t2, **kw))


def _system(seq):
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    return q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=seq,
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 32),
                             z=np.linspace(16e-3, 24e-3, 32)))


SEQS = {
    "PW": lambda: q.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]), c0=1540.0),
    "FC": lambda: q.Sequence(type="FC", focus=np.array([[-2e-3, 0.0, 2e-3],
                                                        [0.0, 0.0, 0.0],
                                                        [20e-3, 20e-3, 20e-3]]),
                             c0=1540.0),
}


@pytest.mark.parametrize("method", ["cubic", "freq"])
@pytest.mark.parametrize("seq", sorted(SEQS))
def test_focus_tx_matches_reference(seq, method):
    us = _system(SEQS[seq]())
    ust = from_reference(us)
    rng = np.random.default_rng(36)
    x = (rng.standard_normal((160, 16, 16))
         + 1j * rng.standard_normal((160, 16, 16))).astype(np.complex64)
    chd = q.ChannelData(data=x, fs=us.fs, t0=2.5e-6)
    ref = us.focusTx(chd, method=method)
    got = ust.focusTx(from_reference(chd), method=method, device="cpu")
    close(got.data, ref.data)
    assert got.data.shape[2] == 3 and np.array_equal(got.t0_host, ref.t0_host)


def test_focus_tx_real_frames_matches_reference():
    """Real traces with a trailing frame dim keep both through focusTx."""
    us = _system(SEQS["PW"]())
    x = np.random.default_rng(37).standard_normal((120, 16, 16, 2)).astype(np.float32)
    chd = q.ChannelData(data=x, fs=us.fs, t0=0.0)
    for method in ("cubic", "freq"):
        ref = us.focusTx(chd, method=method)
        got = from_reference(us).focusTx(from_reference(chd), method=method, device="cpu")
        assert got.data.dtype == torch.float32
        close(got.data, ref.data)


def test_greens_plane_wave_matches_reference():
    """greens on a PW system: the FSA simulation, then focusTx; the shifted
    t0 crosses over exactly, and DAS(bsize) slices it per transmit."""
    us = _system(SEQS["PW"]())
    scat = q.Scatterers(pos=TARGET[:, None], c0=1540.0)
    chd = us.greens(scat)
    chdt = from_reference(us).greens(from_reference(scat), device="cpu")
    close(chdt.data, chd.data, 2e-4)  # 2e-4: the FSA traces' FMA ulps (test_torch_system)
    assert np.array_equal(chdt.t0_host, chd.t0_host)
    ref = np.asarray(us.DAS(chd, bsize=2))
    ust = from_reference(us)
    close(ust.DAS(chdt, bsize=2, device="cpu"), ref, 2e-4)
    close(ust.DAS(chdt, bsize=2, device="cpu"), ust.DAS(chdt, device="cpu"))
