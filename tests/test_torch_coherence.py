"""Aperture coherence in the port against the JAX package, on the CPU: the
five reductions of ``ops/coherence.py`` (cohfac, slsc with both methods,
lags as an int and as a list, and a kernel axis, dmas, pcf, pwznxcorr) on
the same real and complex numpy inputs, and
``UltrasoundSystem.coherence_image`` (cohfac, slsc) frame by frame. The
keep_rx beamformer under coherence_image on the card: test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu.ops import coherence as jc  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import coherence as tc  # noqa: E402

TOL = 1e-5  # float32 reductions of a few dozen terms, summed in other orders


def _data(cplx, shape=(6, 5, 12), seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("axis", [2, -2])
def test_cohfac_matches_reference(cplx, axis):
    x = _data(cplx)
    _close(tc.cohfac(torch.as_tensor(x), axis=axis), jc.cohfac(x, axis=axis))


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("method", ["average", "ensemble"])
@pytest.mark.parametrize("lags,kaxis", [(None, None), (3, None), ([1, 2, 4], None),
                                        (2, 0), ([1, 3], 1)])
def test_slsc_matches_reference(cplx, method, lags, kaxis):
    x = _data(cplx)
    got = tc.slsc(torch.as_tensor(x), axis=2, lags=lags, method=method, kaxis=kaxis)
    _close(got, jc.slsc(x, axis=2, lags=lags, method=method, kaxis=kaxis))


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("lags", [None, 3, [1, 5, 30]])
def test_dmas_matches_reference(cplx, lags):
    x = _data(cplx)
    _close(tc.dmas(torch.as_tensor(x), axis=-1, lags=lags), jc.dmas(x, axis=-1, lags=lags))


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_pcf_matches_reference(gamma):
    x = _data(True)
    _close(tc.pcf(torch.as_tensor(x), axis=2, gamma=gamma), jc.pcf(x, axis=2, gamma=gamma))
    with pytest.raises(ValueError):
        tc.pcf(torch.as_tensor(_data(False)), axis=2)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("kw", [dict(W=9), dict(W=None, zero=False), dict(W=7, norm=False),
                                dict(W=5, stride=2)])
def test_pwznxcorr_matches_reference(cplx, kw):
    x = _data(cplx, shape=(64, 5, 2), seed=7)
    got = tc.pwznxcorr(torch.as_tensor(x), lags=[-2, 0, 3], **kw)
    _close(got, jc.pwznxcorr(x, lags=[-2, 0, 3], **kw), 1e-4)


def _systems():
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.SequenceRadial(type="PW", angles=np.array([-5.0, 0.0, 5.0]),
                                             c0=1540.0),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 24), z=np.linspace(16e-3, 24e-3, 20)))
    # two silent scatterers give both frames one time window
    chds = [us.greens(q.Scatterers(pos=np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                                                 [z, 14e-3, 26e-3]]),
                                   amp=np.array([1.0, 0.0, 0.0]), c0=1540.0))
            for z in (20e-3, 20.3e-3)]
    return us, from_reference(us), chds


@pytest.fixture(scope="module")
def pw():
    return _systems()


@pytest.mark.parametrize("post,lags", [("cohfac", None), ("slsc", None), ("slsc", 3),
                                       ("slsc", [1, 2, 5])])
def test_coherence_image_matches_reference_per_frame(pw, post, lags):
    """Two frames in one call against the JAX package's coherence_image on
    each frame alone (its two-step path sums the frames first: ROADMAP
    Queue 3). cohfac within 1e-4 of the image's largest value: the keep_rx
    terms carry the delay rounding of test_torch_apod.py's kept terms (XLA
    contracts the delays into FMAs, the port does not) into a ratio. slsc
    within 1e-3: it scales each receiver's sample to unit magnitude, so
    where a sample lies at the rounding floor (|b| ~ 1e-6 against a peak
    of 2e5 here) its phase is the rounding's (measured: 1.02e-4)."""
    us, ust, chds = pw
    frames = np.stack([np.asarray(c.data) for c in chds], -1)
    chdt = from_reference(chds[0])
    chdt = chdt.replace(data=torch.as_tensor(frames))
    got = ust.coherence_image(chdt, post=post, lags=lags, device="cpu")
    assert got.shape == tuple(ust.scan.shape) + (2,)
    assert bool(torch.isfinite(got).all())
    for f, chd in enumerate(chds):
        ref = np.asarray(us.coherence_image(chd, post=post, lags=lags))
        g = got[..., f].numpy()
        assert g.shape == ref.shape and g.dtype == ref.dtype
        tol = 1e-4 if post == "cohfac" else 1e-3
        assert np.abs(g - ref).max() < tol * np.abs(ref).max(), (post, lags, f)
    if post == "cohfac":
        assert float(got.max()) <= 1 + 1e-6


def test_coherence_image_scope(pw):
    """What coherence_image does not carry raises: a mesh (several cards);
    an unknown post is a ValueError. The trace precisions run (K1(e) on the
    card); on the CPU the plain path ignores them, as the JAX package's XLA
    path does."""
    _, ust, chds = pw
    chdt = from_reference(chds[0])
    with pytest.raises(NotImplementedError):
        ust.coherence_image(chdt, device="cpu", mesh=object())
    ref = ust.coherence_image(chdt, device="cpu")
    for precision in ("bf16pair", "i8x4", "bf16"):
        assert torch.equal(ust.coherence_image(chdt, device="cpu", precision=precision), ref)
    with pytest.raises(ValueError):
        ust.coherence_image(chdt, post="dmas", device="cpu")
    cf = ust.coherence_image(chdt, device="cpu", kernel="plain", method="linear")
    assert cf.shape == tuple(ust.scan.shape) and float(cf.max()) <= 1 + 1e-6
    assert isinstance(qt.ops.cohfac(torch.ones(3, 4), axis=1), torch.Tensor)
