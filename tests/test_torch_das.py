"""The port's delay-and-sum (qups_tpu_torch.ops.das.das, the plain version
of kernel K1) against qups_tpu's das for 3 transmit models x 4 samplers,
one case against the Pallas kernel das_tiled in interpret mode, and the
wrapper's CPU path. K1 itself is tested on the card in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qups_tpu.ops.das import das as das_ref  # noqa: E402
from qups_tpu.ops.das import delay_tables as delay_tables_ref  # noqa: E402
from qups_tpu.ops.das_pallas import das_tiled  # noqa: E402
from qups_tpu_torch.ops import das_cuda  # noqa: E402
from qups_tpu_torch.ops.das import das, delay_tables  # noqa: E402
from qups_tpu_torch.ops.interp import METHODS  # noqa: E402

CINV = np.float32(1 / 1540.0)


def problem(model, T=256, N=16, M=4, I1=16, I2=32, seed=20, cplx=False):
    """Random traces and a z-major pixel grid; t0 puts some delays below 0
    and some above T-1 at fs = 4 MHz."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal((T, N, M))).astype(np.complex64)
    Z, X = np.meshgrid(np.linspace(5e-3, 45e-3, I1), np.linspace(-12e-3, 12e-3, I2),
                       indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)
    pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    if model == "plane":
        th = np.radians(np.linspace(-9, 9, M))
        pv = np.zeros((M, 3), np.float32)
        nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1).astype(np.float32)
    else:
        zf = -10e-3 if model == "diverging" else 20e-3
        pv = np.stack([np.linspace(-3e-3, 3e-3, M), np.zeros(M), np.full(M, zf)],
                      -1).astype(np.float32)
        nv = np.tile([0.0, 0.0, 1.0], (M, 1)).astype(np.float32)
    t0 = (2 * 12e-3 / 1540.0 + np.linspace(0, 2e-6, M)).astype(np.float32)
    return x, pi, pr, pv, nv, t0


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("model", ["plane", "diverging", "virtual"])
def test_das_matches_reference(model, method):
    x, pi, pr, pv, nv, t0 = problem(model)
    ref = np.asarray(das_ref(x, pi, pr, pv, nv, t0, CINV, fs=4e6,
                             tx_model=model, method=method))
    got = das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, fs=4e6,
              tx_model=model, method=method).numpy()
    assert got.shape == ref.shape == (pi.shape[0], 1, 1)
    off = np.abs(got - ref) >= 1e-4 * np.abs(ref).max()
    if method == "nearest":
        # XLA on the CPU contracts the delay arithmetic into FMAs, so its
        # delays differ from the port's by an ulp; where a delay lies within
        # an ulp of a half-integer, nearest takes the neighbouring sample.
        # Such flips are allowed on at most 1% of pixels. (The port and K1
        # round identically and are held to 1e-4 everywhere.)
        assert off.mean() <= 0.01, off.mean()
    else:
        assert not off.any()


@pytest.mark.parametrize("model", ["plane", "diverging", "virtual"])
def test_delay_tables(model):
    x, pi, pr, pv, nv, t0 = problem(model)
    for got, ref in zip(delay_tables(pi, pr, pv, nv, 1540.0, model, device="cpu"),
                        delay_tables_ref(pi, pr, pv, nv, 1540.0, model)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() < 1e-4 * np.abs(ref).max()


def test_das_matches_pallas_interpret():
    """The port against the TPU kernel itself, run as the JAX package's own
    tests run it on the CPU (interpret mode; 128-wide iso-depth rows)."""
    x, pi, pr, pv, nv, t0 = problem("plane", I1=8, I2=128)
    ref = np.asarray(das_tiled(x, pi, pr, pv, nv, t0, CINV, fs=4e6,
                               tx_model="plane", method="cubic",
                               im_shape=(8, 128, 1), interpret=True)).squeeze()
    got = das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, fs=4e6,
              tx_model="plane", method="cubic").numpy().squeeze()
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["keep_rx", "keep_tx", "apod_fmod_complex"])
def test_das_general_modes(case):
    """The plain path carries the modes that K1 leaves to later sub-slices."""
    x, pi, pr, pv, nv, t0 = problem("virtual", cplx=case == "apod_fmod_complex")
    kw = dict(fs=4e6, tx_model="virtual", method="linear")
    if case == "keep_rx":
        kw["keep_rx"] = True
    elif case == "keep_tx":
        kw["keep_tx"] = True
    else:
        rng = np.random.default_rng(21)
        kw.update(fmod=1e6, im_shape=(16, 32, 1),
                  apod=(rng.uniform(size=(16, 1, 1, 16, 1)).astype(np.float32),
                        rng.uniform(size=(1, 32, 1, 1, 4)).astype(np.float32)))
    ref = np.asarray(das_ref(x, pi, pr, pv, nv, t0, CINV, **kw))
    got = das(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, **kw).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()


def test_das_sum_cpu_is_plain():
    """On a CPU tensor the K1 wrapper runs the plain version and launches
    nothing."""
    x, pi, pr, pv, nv, t0 = problem("plane")
    before = das_cuda.LAUNCHES
    args = (torch.as_tensor(x), pi, pr, pv, nv, t0, CINV)
    kw = dict(fs=4e6, tx_model="plane", method="cubic")
    got = das_cuda.das_sum(*args, **kw)
    assert torch.equal(got, das_cuda.das_sum_plain(*args, **kw))
    assert torch.equal(got, das(*args, **kw))
    assert das_cuda.LAUNCHES == before

