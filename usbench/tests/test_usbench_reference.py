"""The plain reference against cases worked by hand."""
import math

import numpy as np
import pytest
import torch

from usbench.reference import analytic, das_at, downmix
from usbench.reference.das import catmull_rom


def _one(taps_np, pix, ele, dirs, **kw):
    x = torch.as_tensor(taps_np, dtype=torch.float64)
    return das_at(lambda m: x[:, :, m], np.asarray(pix, np.float32),
                  np.asarray(ele, np.float32), np.asarray(dirs, np.float32), **kw)


def test_one_pixel_cubic_sum_by_hand():
    # one element at x = 1 mm, one plane wave straight down, pixel (0, 0, 3 mm):
    # tau = (3 mm + sqrt(1 + 9) mm) / c - t0, t = tau fs
    T, c0, fs, t0 = 64, 1500.0, 10e6, 1e-6
    x = np.arange(T, dtype=np.float64) ** 2  # samples n^2
    d = 3e-3 + math.sqrt(1e-6 + 9e-6)
    t = (d / c0 - t0) * fs
    b = math.floor(t)
    u = t - b
    w = (0.5 * u * (-1 + u * (2 - u)), 0.5 * (2 + u * u * (-5 + 3 * u)),
         0.5 * u * (1 + u * (4 - 3 * u)), 0.5 * u * u * (u - 1))
    want = sum(wk * (b - 1 + k) ** 2 for k, wk in enumerate(w))
    got = _one(x[:, None, None, None], [[0, 0, 3e-3]], [[1e-3, 0, 0]], [[0, 0, 1]],
               T=T, t0=t0, c0=c0, fs=fs)
    assert float(got[0, 0]) == pytest.approx(want, rel=1e-6)
    # the cubic is exact on a quadratic: n^2 at t
    assert want == pytest.approx(t * t, rel=1e-6)


def test_catmull_rom_weights_sum_to_one_and_interpolate():
    u = torch.linspace(0, 1, 11, dtype=torch.float64)
    w = catmull_rom(u)
    assert torch.allclose(sum(w), torch.ones_like(u))
    assert [float(a[0]) for a in w] == [0.0, 1.0, 0.0, 0.0]


def test_an_echo_focuses_at_its_pixel():
    # a unit sample at the delay of pixel p0 in every (element, plane wave)
    # trace: the image is N * M at p0, where every term reads the sample
    T, c0, fs, t0 = 400, 1540.0, 20e6, 0.0
    ele = np.stack([np.linspace(-2e-3, 2e-3, 5), np.zeros(5), np.zeros(5)], -1)
    a = np.radians([-5.0, 0.0, 5.0])
    dirs = np.stack([np.sin(a), np.zeros(3), np.cos(a)], -1)
    p0 = np.array([0.5e-3, 0.0, 8e-3])
    x = np.zeros((T, 5, 3, 1))
    for n in range(5):
        for m in range(3):
            tau = (p0 @ dirs[m] + np.linalg.norm(p0 - ele[n])) / c0
            x[int(round(tau * fs)), n, m, 0] = 1.0
    pix = np.stack([np.full(9, 0.5e-3), np.zeros(9), np.linspace(7e-3, 9e-3, 9)], -1)
    img = _one(x, pix, ele, dirs, T=T, t0=t0, c0=c0, fs=fs)[:, 0].abs()
    assert int(img.argmax()) == 4
    assert float(img[4]) > 0.5 * 15  # the nearest sample, weight a1(u) >= 0.5625


def test_terms_off_the_trace_are_zero():
    x = np.ones((16, 1, 1, 1))
    got = _one(x, [[0, 0, 1e-2]], [[0, 0, 0]], [[0, 0, 1]], T=16, t0=0.0, c0=1540.0,
               fs=20e6)
    assert float(got[0, 0]) == 0.0  # the delay is sample 260, past T - 1


def test_analytic_and_downmix_of_a_tone():
    T, fs, fc = 256, 20e6, 20e6 * 16 / 256  # a bin-centred tone
    n = torch.arange(T, dtype=torch.float64)
    z = analytic(torch.cos(2 * math.pi * fc * n / fs))
    assert torch.allclose(z, torch.exp(2j * math.pi * fc * n / fs), atol=1e-9)
    bb = downmix(z[:, None], fc, 0.0, fs)
    assert torch.allclose(bb, torch.ones_like(bb), atol=1e-4)  # float32 phase


def test_remodulation_rotates_by_the_delay():
    # a constant baseband trace: each term is exp(2j pi fmod tau)
    T, c0, fs, fmod = 64, 1540.0, 20e6, 5e6
    x = torch.ones((T, 1, 1, 1), dtype=torch.complex128)
    pix = np.array([[0, 0, 1e-3]], np.float32)
    got = das_at(lambda m: x[:, :, m], pix, np.zeros((1, 3), np.float32),
                 np.array([[0, 0, 1]], np.float32), T=T, t0=0.0, c0=c0, fs=fs, fmod=fmod)
    tau = 2e-3 / c0
    assert complex(got[0, 0]) == pytest.approx(np.exp(2j * np.pi * fmod * tau), abs=1e-5)


def test_one_scatterers_echo_peaks_at_its_round_trip():
    from usbench.reference import sim

    fc, fs, c0 = 5e6, 40e6, 1540.0
    ele = np.array([[-1e-3, 0, 0], [0.0, 0, 0], [1e-3, 0, 0]])
    p = np.array([[0.5e-3, 0.0, 12e-3]], np.float32)
    x, s0 = sim.fsa_echoes(p, np.ones(1, np.float32), ele, fc=fc, bw=0.6, fs=fs, c0=c0,
                           R0=c0 / fc)
    for n in range(3):
        for m in range(3):
            r = np.linalg.norm(p[0] - ele[n]) + np.linalg.norm(p[0] - ele[m])
            t_pk = s0 + int(x[:, n, m].abs().argmax()) / fs
            assert abs(t_pk - r / c0) <= 0.5 / fs
    # the plane-wave synthesis of a straight-down wave: the echo at p.z + r_n
    y, t0 = sim.plane_wave_synthesis(x, s0, ele, np.array([[0.0, 0, 1]]), fs=fs, c0=c0)
    t_pk = t0 + int(y[:, 1, 0].abs().argmax()) / fs
    assert abs(t_pk - (p[0, 2] + np.linalg.norm(p[0] - ele[1])) / c0) <= 0.5 / fs
