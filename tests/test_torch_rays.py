"""The port's ray path integrals against qups_tpu, on the CPU: the seven
tests of ``tests/test_rays.py`` with the port's functions, each also held
against the JAX package's on the same inputs, and the device path
(``ray_paths_device``, ``wbilerp_dense``) with ``device="cpu"``.

Tolerances: the host functions are the same float64 numpy as the JAX
package's, so their outputs are held equal (0, well inside 1e-12). The
device path (float64 crossings, float32 weights) within 1e-5 x the largest
weight of the float64 host weights, the JAX test's bound (measured 8e-8 on
the 13 x 9 grid, 1.3e-7 on a 256^2 grid), and of the JAX device path,
whose crossings are float32 (measured 4.2e-7, JAX's own distance from the
host weights).
"""
import inspect
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qups_tpu.ops import rays as jrays  # noqa: E402
from qups_tpu_torch.ops import rays  # noqa: E402
from qups_tpu_torch.ops.rays import (global_average_c, ray_paths, ray_paths_device,  # noqa: E402
                                     wbilerp, wbilerp_dense, xiaolinwu_line)


def test_wbilerp_total_weight_is_length():
    # weights of the bilinear interpolant of f=1 sum to the segment length
    xg = np.linspace(0, 10e-3, 11)
    zg = np.linspace(0, 10e-3, 11)
    rng = np.random.default_rng(3)
    for _ in range(10):
        pa = rng.uniform(0, 10e-3, 2)
        pb = rng.uniform(0, 10e-3, 2)
        iz, ix, w = wbilerp(xg, zg, pa, pb)
        L = np.hypot(*(pb - pa))
        assert np.isclose(w.sum(), L, rtol=1e-9), (w.sum(), L)
        for a, b in zip((iz, ix, w), jrays.wbilerp(xg, zg, pa, pb)):
            np.testing.assert_array_equal(a, b)


def test_wbilerp_linear_field_exact():
    # integral of a linear field along the line is exact under bilerp
    xg = np.linspace(0, 1.0, 6)
    zg = np.linspace(0, 1.0, 6)
    f = lambda x, z: 2.0 * x + 3.0 * z + 1.0  # noqa: E731
    F = f(xg[None, :], zg[:, None])  # (nz, nx) nodal values
    pa = np.array([0.05, 0.1])
    pb = np.array([0.9, 0.85])
    iz, ix, w = wbilerp(xg, zg, pa, pb)
    got = (w * F[iz, ix]).sum()
    L = np.hypot(*(pb - pa))
    want = 0.5 * (f(*pa) + f(*pb)) * L
    assert np.isclose(got, want, rtol=1e-9)
    Wd = wbilerp_dense(xg, zg, pa, pb, device="cpu").double().numpy()
    assert np.isclose((Wd * F).sum(), want, rtol=1e-6)


def test_wbilerp_axis_aligned():
    xg = np.arange(5.0)
    zg = np.arange(5.0)
    iz, ix, w = wbilerp(xg, zg, (1.0, 2.0), (3.0, 2.0))  # along x at z=2
    assert set(iz) == {2}
    assert np.isclose(w.sum(), 2.0)
    Wd = wbilerp_dense(xg, zg, np.array([1.0, 2.0]), np.array([3.0, 2.0]), device="cpu")
    assert float(Wd.sum()) == pytest.approx(2.0, abs=1e-6)
    assert float(Wd[2].sum()) == pytest.approx(2.0, abs=1e-6)


def test_xiaolinwu_weights():
    px, py, w = xiaolinwu_line(0, 0, 8, 3)
    assert len(px) == len(w)
    assert 0 < w.min() <= w.max() <= 1
    for a, b in zip((px, py, w), jrays.xiaolinwu_line(0, 0, 8, 3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["bilerp", "xiaolinwu"])
def test_ray_paths_travel_time(method):
    # travel time through constant slowness = length / c
    xg = np.linspace(0, 20e-3, 21)
    zg = np.linspace(0, 20e-3, 21)
    c = 1500.0
    pa = np.array([[1e-3], [1e-3]])
    pb = np.array([[18e-3], [15e-3]])
    W = ray_paths(xg, zg, pa, pb, method=method)
    np.testing.assert_array_equal(W, jrays.ray_paths(xg, zg, pa, pb, method=method))
    if method == "bilerp":
        t = (W[:, :, 0] / c).sum()
        assert np.isclose(t, np.hypot(17e-3, 14e-3) / c, rtol=1e-9)


def test_global_average_c_two_layers():
    xg = np.linspace(0, 10e-3, 21)
    zg = np.linspace(0, 20e-3, 41)
    C = np.full((41, 21), 1500.0)
    C[20:, :] = 1000.0  # bottom half slower
    pa = np.array([5e-3, 0.0])
    pb = np.array([[5e-3], [20e-3]])  # straight down through both layers
    cbar = global_average_c(C, xg, zg, pa, pb)
    want = 20e-3 / (10e-3 / 1500 + 10e-3 / 1000)
    assert np.isclose(cbar[0], want, rtol=0.02)
    np.testing.assert_array_equal(cbar, jrays.global_average_c(C, xg, zg, pa, pb))


def test_wbilerp_dense_matches_host():
    """The device path matches the exact host computation across ray
    orientations, and the JAX package's device path."""
    import jax.numpy as jnp

    xg = np.linspace(0.0, 10e-3, 13)
    zg = np.linspace(0.0, 8e-3, 9)
    rng = np.random.default_rng(3)
    pa = rng.uniform(0, 10e-3, (2, 8))
    pb = rng.uniform(0, 10e-3, (2, 8))
    pa[1] *= 0.8
    pb[1] *= 0.8
    Wh = ray_paths(xg, zg, pa, pb)                       # host f64
    Wd = ray_paths_device(xg, zg, pa, pb, device="cpu").numpy()
    Wj = np.asarray(jrays.ray_paths_device(jnp.asarray(xg, jnp.float32),
                                           jnp.asarray(zg, jnp.float32), pa, pb))
    assert Wd.shape == Wh.shape == Wj.shape
    assert np.abs(Wd - Wh).max() < 1e-5 * np.abs(Wh).max()
    assert np.abs(Wd - Wj).max() < 1e-5 * np.abs(Wj).max()
    L = np.hypot(*(pb - pa))
    assert np.allclose(Wd.sum(axis=(0, 1)), L, atol=1e-6)


@pytest.mark.parametrize("chunk", [None, 3])
def test_ray_paths_device_broadcast_and_chunks(chunk, monkeypatch):
    """One source to many receivers ((2,) against (R, 2)), axis-aligned,
    degenerate and off-grid rays, through chunks of rays: the host
    weights within 1e-5 of the largest weight, each ray's total its
    in-grid length."""
    xg = np.linspace(-5e-3, 5e-3, 17)
    zg = np.linspace(0.0, 12e-3, 25)
    pa = np.array([0.0, 0.0])
    pb = np.array([[-5e-3, 12e-3], [0.0, 12e-3], [3e-3, 6e-3], [0.0, 0.0], [5e-3, 0.0],
                   [4e-3, 9e-3], [-2e-3, 11e-3]])
    if chunk:  # rays by chunks of 3
        monkeypatch.setattr(rays, "CHUNK_SEGMENTS", chunk * (17 + 25 + 1))
    Wd = ray_paths_device(xg, zg, pa, pb, device="cpu").numpy()
    Wh = ray_paths(xg, zg, pa, pb)
    assert Wd.shape == (25, 17, 7)
    assert np.abs(Wd - Wh).max() < 1e-5 * np.abs(Wh).max()
    assert np.allclose(Wd.sum(axis=(0, 1)), np.hypot(*(pb - pa).T), atol=1e-6)
    assert not Wd[:, :, 3].any()  # a ray of zero length has no weight


def test_ray_paths_device_rejects_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the device path runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ray_paths_device(np.arange(4.0), np.arange(4.0), np.zeros(2), np.ones(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wbilerp_dense(np.arange(4.0), np.arange(4.0), np.zeros(2), np.ones(2))


def _examples():
    objs = (rays.ray_paths, rays.ray_paths_device, rays.wbilerp_dense)
    return [(o.__qualname__, textwrap.dedent(inspect.getdoc(o).split("Example:", 1)[1]))
            for o in objs]


@pytest.mark.parametrize("name,code", _examples(), ids=lambda v: v[:32])
def test_docstring_examples_run(name, code):
    exec(compile(code, name, "exec"), {})
