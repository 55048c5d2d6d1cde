"""The port's ChannelData DSP surface, the maths helpers, xcorr,
fft_upsample and interpf against qups_tpu's, on the same seeded numpy
inputs in one process. Tolerances: max|port - JAX| < 1e-5 * max|JAX| where
the method is an FFT or exact arithmetic, < 1e-4 * max|JAX| where it
samples (resample, rectifyt0, align_int: the samplers of ops/interp.py);
the FIR designs equal in float64; t0 equal after every method that moves
it. Frame dims pass through every method: where the JAX package broadcasts
a per-transmit t0 from the right (onto the last frame dim), the port is
held to the JAX package frame by frame instead."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
from qups_tpu.core import channel_data as jcd  # noqa: E402
from qups_tpu.ops import conv as jconv  # noqa: E402
from qups_tpu.ops import interp as jinterp  # noqa: E402
from qups_tpu.utils import maths as jmaths  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch.core import channel_data as tcd  # noqa: E402
from qups_tpu_torch.ops import conv as tconv  # noqa: E402
from qups_tpu_torch.ops import interp as tinterp  # noqa: E402
from qups_tpu_torch.utils import maths as tmaths  # noqa: E402

FS = 20e6


def traces(T=64, cplx=False, shape=(3, 4, 2), seed=70):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T,) + shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    return x


def pair(x, t0=1.5e-6, fs=FS):
    return q.ChannelData(data=x, fs=fs, t0=t0), qt.ChannelData(data=x, fs=fs, t0=t0)


def close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def same_chd(got, ref, tol):
    """Data within ``tol``, the same fs, and t0 equal (its host values)."""
    close(got.data, ref.data, tol)
    assert got.fs == ref.fs
    assert np.shape(got.t0) == np.shape(ref.t0)
    assert np.array_equal(np.asarray(got.t0, np.float64), np.asarray(ref.t0, np.float64))


H = np.random.default_rng(71).standard_normal((5, 4))

# method -> (call on either package's ChannelData, tolerance): FFTs and exact
# arithmetic 1e-5, samplers 1e-4
CASES = {
    "astype": (lambda c: c.astype(np.complex64), 1e-5),
    "downmix": (lambda c: c.downmix(3e6), 1e-5),
    "hilbert": (lambda c: c.hilbert(), 1e-5),
    "filter_passband": (lambda c: c.filter(c.get_passband_filter((2e6, 6e6), 16)), 1e-5),
    "filter_lowpass": (lambda c: c.filter(c.get_lowpass_filter(5e6, 20)), 1e-5),
    "filter_long": (lambda c: c.filter(np.hanning(80)), 1e-5),  # convd's fft method
    "filtfilt": (lambda c: c.filtfilt(c.get_lowpass_filter(5e6, 10)), 1e-5),
    "downsample": (lambda c: c.downsample(3), 1e-5),
    "resample_cubic": (lambda c: c.resample(13e6), 1e-4),
    "resample_linear": (lambda c: c.resample(31e6, method="linear"), 1e-4),
    "resample_nearest": (lambda c: c.resample(10e6, method="nearest"), 1e-4),
    "convt": (lambda c: c.convt(np.hanning(9), lag0=2e-7), 1e-5),
    "zeropad": (lambda c: c.zeropad(3, 5), 1e-5),
    "rectifyt0_scalar": (lambda c: c.rectifyt0(), 1e-4),
    "align_int": (lambda c: c.align_int(), 1e-4),
    "join": (lambda c: c.join([c * 2.0, c - 1.0]), 1e-5),
    "join_axis4": (lambda c: c.join([c], axis=4), 1e-5),
    "subt": (lambda c: c.subt(5, 40), 1e-5),
    "add": (lambda c: c + c, 1e-5),
    "add_array": (lambda c: c + np.linspace(0, 1, 3).reshape(1, 3, 1, 1), 1e-5),
    "sub": (lambda c: c - 0.5, 1e-5),
    "mul": (lambda c: c * 3.0, 1e-5),
    "div": (lambda c: c / 2.0, 1e-5),
    "neg": (lambda c: -c, 1e-5),
    "txmul": (lambda c: c.txmul(H), 1e-5),
    "real": (lambda c: c.real(), 1e-5),
    "imag": (lambda c: c.imag(), 1e-5),
    "abs": (lambda c: c.abs(), 1e-5),
    "conj": (lambda c: c.conj(), 1e-5),
}


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dsp_method_matches_reference(name, cplx):
    """Each method on (T, N, M, F) traces with a frame dim, real and
    complex, on the data's device (the CPU here)."""
    fn, tol = CASES[name]
    ref_in, got_in = pair(traces(cplx=cplx))
    ref, got = fn(ref_in), fn(got_in)
    assert got.data.device == got_in.data.device
    same_chd(got, ref, tol)
    assert got.is_complex == bool(ref.is_complex)


@pytest.mark.parametrize("T", [64, 65], ids=["even", "odd"])
def test_hilbert_even_and_odd_lengths(T):
    """The analytic signal at even and odd T (the Nyquist bin kept once or
    absent): the real part is the traces, and the whole against JAX."""
    ref_in, got_in = pair(traces(T=T, shape=(2, 3)))
    got = got_in.hilbert()
    same_chd(got, ref_in.hilbert(), 1e-5)
    assert float((got.data.real - got_in.data).abs().max()) < 1e-5


def test_fft_and_axis_match_reference():
    ref_in, got_in = pair(traces(cplx=True))
    close(got_in.fft(), ref_in.fft(), 1e-5)
    close(got_in.fft(100), ref_in.fft(100), 1e-5)
    assert np.array_equal(got_in.fftaxis(), ref_in.fftaxis())
    assert np.array_equal(got_in.fftaxis(100), ref_in.fftaxis(100))


@pytest.mark.parametrize("band", [None, (2e6, 6e6)], ids=["lowpass", "passband"])
@pytest.mark.parametrize("order", [10, 31, 64])
def test_fir_design_equals_reference_in_float64(order, band):
    """_fir_design, the port's numpy copy, gives the JAX package's float64
    taps exactly; the filters of a ChannelData are those taps in float32."""
    lo, hi = (None, 5e6) if band is None else band
    with jax.enable_x64(True):
        ref = np.asarray(jcd._fir_design(order, FS, lo=lo, hi=hi))
    got = tcd._fir_design(order, FS, lo=lo, hi=hi)
    assert got.dtype == ref.dtype == np.float64 and np.array_equal(got, ref)
    ref_in, got_in = pair(traces())
    h = (got_in.get_lowpass_filter(hi, order) if band is None
         else got_in.get_passband_filter(band, order))
    hr = (ref_in.get_lowpass_filter(hi, order) if band is None
          else ref_in.get_passband_filter(band, order))
    assert h.dtype == torch.float32 and np.array_equal(h.numpy(), np.asarray(hr))


@pytest.mark.parametrize("method", ["cubic", "linear", "lanczos3"])
def test_rectifyt0_align_int_per_transmit_t0(method):
    """A per-transmit t0: rectifyt0 resamples every transmit onto the least
    t0 and align_int onto whole samples, against the JAX package on (T, N,
    M) traces; with a frame dim, each frame as its (T, N, M) traces."""
    x = traces(shape=(3, 4, 2))
    t0 = np.array([1.0e-6, 1.23e-6, 0.91e-6, 1.5e-6], np.float32)
    for fn in (lambda c: c.rectifyt0(method=method), lambda c: c.align_int(method=method)):
        got = fn(qt.ChannelData(data=x, fs=FS, t0=t0))
        for f in range(x.shape[3]):
            ref = fn(q.ChannelData(data=x[..., f], fs=FS, t0=t0))
            close(got.data[..., f], ref.data, 1e-4)
            assert got.fs == ref.fs and np.float64(got.t0) == np.float64(ref.t0)


def test_time_and_downmix_with_per_transmit_t0_and_frames():
    """``time`` aligns a per-transmit t0 with the transmit dim also with
    frame dims, so downmix and sample treat each frame as its own (T, N, M)
    traces, as the JAX package does for (T, N, M) traces."""
    x = traces(cplx=True)
    t0 = np.array([1.0e-6, 1.2e-6, 0.9e-6, 1.1e-6], np.float32)
    got = qt.ChannelData(data=x, fs=FS, t0=t0)
    assert tuple(got.time.shape) == (64, 1, 4, 1)
    tau = torch.as_tensor(np.random.default_rng(72).uniform(1e-6, 3e-6, (20, 3, 4))
                          .astype(np.float32))
    for f in range(x.shape[3]):
        ref = q.ChannelData(data=x[..., f], fs=FS, t0=t0)
        close(got.time[..., 0], ref.time, 1e-7)
        close(got.downmix(3e6).data[..., f], ref.downmix(3e6).data, 1e-5)
        close(got.sample(tau[..., None], method="cubic", fmod=2e6)[..., f],
              ref.sample(tau.numpy(), method="cubic", fmod=2e6), 1e-4)


def test_t0_after_the_methods_that_move_it():
    """filter, filtfilt, convt, rectifyt0, align_int and subt move t0 as
    the JAX package does: a float stays a float, a float32 array a float32
    array of the same shape, with the same values."""
    for t0 in (1.5e-6, np.array([1.0e-6, 1.2e-6, 0.9e-6, 1.1e-6], np.float32)):
        ref_in, got_in = pair(traces(shape=(3, 4)), t0=t0)
        for fn in (lambda c: c.filter(c.get_lowpass_filter(5e6, 16)),
                   lambda c: c.filtfilt(c.get_lowpass_filter(5e6, 9)),
                   lambda c: c.convt(np.hanning(7), lag0=-3e-7),
                   lambda c: c.rectifyt0(), lambda c: c.align_int(),
                   lambda c: c.subt(7, 50)):
            got, ref = fn(got_in), fn(ref_in)
            assert type(got.t0) is type(ref.t0)
            assert np.shape(got.t0) == np.shape(ref.t0)
            assert np.array_equal(np.asarray(got.t0), np.asarray(ref.t0))


def test_splice_matches_reference():
    t0 = np.array([1.0e-6, 1.2e-6, 0.9e-6, 1.1e-6], np.float32)
    ref_in, got_in = pair(traces(cplx=True), t0=t0)
    for axis in (2, 3):
        got, ref = got_in.splice(axis), ref_in.splice(axis)
        assert len(got) == len(ref) == got_in.data.shape[axis]
        for g, r in zip(got, ref):
            same_chd(g, r, 1e-5)


def test_estfc_finds_the_tone():
    """estfc of a tone on a whole bin, with noise well below it: the bin's
    frequency, as in the JAX package."""
    T, f0 = 200, 3e6
    t = np.arange(T) / FS
    rng = np.random.default_rng(73)
    x = (np.cos(2 * np.pi * f0 * t)[:, None, None]
         + 0.05 * rng.standard_normal((T, 3, 2))).astype(np.float32)
    ref_in, got_in = pair(x[..., None])
    assert got_in.estfc() == ref_in.estfc() == f0


MATHS = {
    "db2pow": lambda m, a: m.db2pow(a), "pow2db": lambda m, a: m.pow2db(np.abs(a) + 0.1),
    "nan2zero": lambda m, a: m.nan2zero(np.where(a > 1, np.nan, a)),
    "rsqrt": lambda m, a: m.rsqrt(np.abs(a) + 0.1), "deg2rad": lambda m, a: m.deg2rad(a),
    "rad2deg": lambda m, a: m.rad2deg(a), "cosd": lambda m, a: m.cosd(40 * a),
    "sind": lambda m, a: m.sind(40 * a), "vecnorm": lambda m, a: m.vecnorm(a, axis=1),
    "vecnorm_keep": lambda m, a: m.vecnorm(a, axis=0, keepdims=True),
    "vecnorm_complex": lambda m, a: m.vecnorm((a + 1j * a[::-1]).astype(np.complex64)),
}


@pytest.mark.parametrize("name", sorted(MATHS))
def test_maths_helpers_match_reference(name):
    a = np.random.default_rng(74).standard_normal((6, 5)).astype(np.float32)
    got, ref = MATHS[name](tmaths, a), MATHS[name](jmaths, a)
    close(got, ref, 1e-6)


def test_isalmostn_and_next_pow2_match_reference():
    a = np.array([1.0, np.nan, 3.0], np.float32)
    for b, tol in ((a, None), (a + 1e-6, None), (a + 1e-3, None), (a + 1e-3, 1e-2),
                   (np.array([1.0, 2.0, 3.0]), None), (a[:2], None)):
        assert tmaths.isalmostn(a, b, tol) == jmaths.isalmostn(a, b, tol)
    for n in (0, 1, 2, 3, 5, 64, 1000, 4097):
        assert tmaths.next_pow2(n) == jmaths.next_pow2(n)


@pytest.mark.parametrize("shape", ["full", "same", "valid"])
@pytest.mark.parametrize("method", ["direct", "fft"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_xcorr_matches_reference(cplx, method, shape):
    rng = np.random.default_rng(75)
    x = traces(T=50, cplx=cplx, shape=(3,))
    y = rng.standard_normal((9, 3)).astype(np.float32)
    if cplx:
        y = (y + 1j * rng.standard_normal(y.shape)).astype(np.complex64)
    got = tconv.xcorr(torch.as_tensor(x), torch.as_tensor(y), axis=0, shape=shape,
                      method=method)
    close(got, jconv.xcorr(x, y, axis=0, shape=shape, method=method), 1e-5)


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("T", [32, 33], ids=["even", "odd"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_fft_upsample_matches_reference(cplx, T, r):
    """Band-limited upsampling, even and odd lengths (the Nyquist bin split
    or absent), along the first and a later axis."""
    x = traces(T=T, cplx=cplx, shape=(3, 2))
    close(tinterp.fft_upsample(torch.as_tensor(x), r),
          jinterp.fft_upsample(x, r), 1e-5)
    xt = np.moveaxis(x, 0, 1).copy()
    close(tinterp.fft_upsample(torch.as_tensor(xt), r, axis=1),
          jinterp.fft_upsample(xt, r, axis=1), 1e-5)


def test_fft_upsample_keeps_floating_output():
    """Integer traces give floating output (the JAX package casts back to
    the input's integer type)."""
    x = np.arange(16, dtype=np.int32).reshape(8, 2)
    got = tinterp.fft_upsample(torch.as_tensor(x), 2)
    assert got.is_floating_point()
    close(got, jinterp.fft_upsample(x.astype(np.float32), 2), 1e-5)


@pytest.mark.parametrize("chunk", [0, 7])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_interpf_matches_reference(cplx, chunk):
    """The Fourier interpolant at fractional indices, delays broadcast
    left-aligned against the traces, whole and by blocks of queries."""
    x = traces(T=40, cplx=cplx, shape=(3, 2))
    tau = np.random.default_rng(76).uniform(0, 39, (20, 3, 1)).astype(np.float32)
    close(tinterp.interpf(torch.as_tensor(x), torch.as_tensor(tau), chunk=chunk),
          jinterp.interpf(x, tau, chunk=chunk), 1e-5)
