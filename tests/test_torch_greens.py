"""The port's Green's-function simulators (qups_tpu_torch.ops.greens) against
qups_tpu's: the splat (scatter-add + FFT) and the dense oracle."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qups_tpu.ops.greens import greens_dense as dense_ref  # noqa: E402
from qups_tpu.ops.greens import greens_splat as splat_ref  # noqa: E402
from qups_tpu_torch.ops.greens import greens_dense, greens_splat  # noqa: E402


def problem(cplx):
    """6 scatterers, 4 rx x 3 tx elements, a 24-tap kernel sampled at 8
    samples per carrier period."""
    rng = np.random.default_rng(30)
    t = np.arange(24) - 12.0
    kern = np.exp(-(t / 5.0) ** 2) * (np.exp(2j * np.pi * t / 8) if cplx
                                      else np.cos(2 * np.pi * t / 8))
    ps = np.stack([rng.uniform(-3e-3, 3e-3, 6), np.zeros(6),
                   rng.uniform(8e-3, 12e-3, 6)], -1)
    amp = rng.uniform(0.5, 1.5, 6)
    pn = np.stack([np.linspace(-2e-3, 2e-3, 4), np.zeros(4), np.zeros(4)], -1)[:, None]
    pv = np.stack([np.linspace(-1e-3, 1e-3, 3), np.zeros(3), np.zeros(3)], -1)[:, None]
    kw = dict(T=160, s0=1.0e-5, t0k=-12 / 8e6, fs=8e6, cinv=1 / 1540.0, R0=1e-4)
    return kern, ps, amp, pn, pv, kw


def _check(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_greens_splat(cplx, method):
    kern, ps, amp, pn, pv, kw = problem(cplx)
    ref = splat_ref(kern.astype(np.complex64 if cplx else np.float32),
                    ps.astype(np.float32), amp, pn, pv, method=method, block=4, **kw)
    got = greens_splat(kern, ps, amp, pn, pv, method=method, block=4, device="cpu", **kw)
    _check(got, ref)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_greens_dense(cplx):
    kern, ps, amp, pn, pv, kw = problem(cplx)
    ref = dense_ref(kern.astype(np.complex64 if cplx else np.float32),
                    ps.astype(np.float32), amp, pn, pv, **kw)
    got = greens_dense(kern, ps, amp, pn, pv, device="cpu", **kw)
    _check(got, ref)
