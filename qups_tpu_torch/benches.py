"""Benchmark sweeps of the port, the counterparts of the JAX package's root
``benches.py`` (the reference's ParTest suite, ``test/ParTest.m:244-318``),
each printing one JSON line per configuration:

  python -m qups_tpu_torch.benches das        # s/frame vs image size (K1)
  python -m qups_tpu_torch.benches greens     # us/scatterer vs cloud size (K3, K5)
  python -m qups_tpu_torch.benches coherence  # keep_rx DAS + cohfac/slsc (K1(c))
  python -m qups_tpu_torch.benches lut        # delay-table DAS at the headline (K2)
  python -m qups_tpu_torch.benches focus      # focusTx, M' = 128 and 1
  python -m qups_tpu_torch.benches adjoint    # bfAdjoint at the headline (K4)
  python -m qups_tpu_torch.benches refocus    # REFoCUS decode, cold and cached
  python -m qups_tpu_torch.benches fdtd       # k-space stepper, ms/step
  python -m qups_tpu_torch.benches eikonal    # host fast marching, ms/map
  python -m qups_tpu_torch.benches migration  # Stolt migration, s/frame
  python -m qups_tpu_torch.benches all [--device cpu]

Every bench runs on the CUDA card (``--device``, default the CUDA device,
raising without one; ``--device cpu`` runs the plain versions) with the
JAX functions' shapes, seeds, sizes and JSON keys. Each calls what the JAX
function calls on an accelerator, in the port: ``ops.das_sum`` (K1),
``ops.das_lut_sum`` on tables made on the card once (K2), ``ops.das_sum``
with ``keep_rx`` then ``ops.coherence`` (K1(c)), ``ops.greens_freq`` (K3)
and ``ops.greens_tiled`` (K5; on the CPU the splat, as the JAX file),
``bfAdjoint`` (K4), ``focusTx``, ``refocus``, ``sim.fdtd.kspace_sim_2d``,
``ops.eikonal.msfm`` (host) and ``ops.stolt_migration``. A timed call ends
with its result's ``sum(|.|)`` read to the host (``migration``: a
synchronise), after one untimed call (``bench.timed``).

Knobs (the JAX file's): QUPS_BENCH_BUDGET (seconds per sweep, default 60:
a sweep stops when it is exceeded, like the reference), QUPS_BENCH_TINY=1
(smoke sizes), QUPS_BENCH_SIZE=full (coherence at the headline),
QUPS_BENCH_PRECISION (lut and coherence; default f32 on every device, the
port's default trace precision; bf16pair is the JAX file's default on an
accelerator), QUPS_BENCH_IMPL (greens: one engine), QUPS_BENCH_ADJ_BINS,
QUPS_BENCH_ADJ_KERNEL (auto | cuda | plain; JAX: auto | xla) and
QUPS_BENCH_FOCUS_METHOD. The samplers are the JAX calls': das, lut's first
line and coherence linear (the JAX ``das_tiled`` default; the port's
``das_sum`` defaults to cubic), greens linear.

A configuration that fails prints ``{"bench": ..., "error": ...}`` and the
sweep goes on, as in the JAX file; ``main`` then names every error on
stderr and exits 1, so a failed run never ends with 0.

Not ported (TPU-only): ``out="ri"`` and ``ri_split`` (the TPU's complex
transfer contract: migration returns complex64), ``interpret=`` (the port
runs its plain versions on the CPU), the ``jax.jit`` wrappers, and
``_upload_trace``'s wire format. No line carries a key of these.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

import qups_tpu_torch as qt
from qups_tpu_torch import ops, system
from qups_tpu_torch.bench import pixels, plane_array, timed
from qups_tpu_torch.sim.fdtd import kspace_sim_2d
from qups_tpu_torch.utils.backend import default_device

FS, C0 = 31.25e6, 1540.0


def _budget():
    return float(os.environ.get("QUPS_BENCH_BUDGET", "60"))


def _tiny():
    return os.environ.get("QUPS_BENCH_TINY", "") == "1"


def _emit(out, rec):
    print(json.dumps(rec), flush=True)
    out.append(rec)


def _fail(out, rec, e):
    traceback.print_exc(file=sys.stderr)
    _emit(out, {**rec, "error": f"{type(e).__name__}: {e}"})


def _total(t) -> float:
    return float(torch.sum(torch.abs(t)))


def sweep_geometry(N, M):
    """(pr, pv, nv, t0): the headline's receivers and plane waves
    (:func:`~qups_tpu_torch.bench.plane_array`), each transmit starting at
    0."""
    return (*plane_array(N, M), np.zeros(M, np.float32))


def traces(shape, dev):
    """The sweeps' traces: seed 0, float32, on ``dev``. The headline's
    traces (:func:`~qups_tpu_torch.bench.das_problem`) are the same draw."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(dev)


# ------------------------------------------------------------------- das
def das_image(x, pi, n, method="linear", **kw):
    """The das sweep's image of traces ``x (T, N, M)`` at the n x n pixels
    ``pi`` (:func:`~qups_tpu_torch.bench.pixels`, host numpy: each call
    uploads them, as the JAX call does)."""
    pr, pv, nv, t0 = sweep_geometry(x.shape[1], x.shape[2])
    return ops.das_sum(x, pi, pr, pv, nv, t0, 1 / C0, fs=FS, tx_model="plane",
                       method=method, im_shape=(n, n, 1), **kw)


def bench_das(dev, out):
    """DAS s/frame vs image size: 2^6..2^12 px a side, T 1024, 128 x 128
    tx/rx (``ParTest.m:244-271``), K1 linear."""
    T, N, M = (256, 16, 4) if _tiny() else (1024, 128, 128)
    x = traces((T, N, M), dev)
    start = time.time()
    for n in [64, 128] if _tiny() else [64, 128, 256, 512, 1024, 2048, 4096]:
        if time.time() - start > _budget():
            break
        pi = pixels(n)
        try:
            dt = timed(lambda: _total(das_image(x, pi, n)), 1)[0]
        except Exception as e:  # a configuration's failure is a line; the sweep goes on
            _fail(out, {"bench": "das", "n": n}, e)
            continue
        _emit(out, {"bench": "das", "metric": "s/frame", "n_px_side": n, "value": dt,
                    "sums_per_s": n * n * N * M / dt, "T": T, "N": N, "M": M})


# ---------------------------------------------------------------- greens
def greens_problem(S, N, rng):
    """The greens sweep's kernel, S scatterers and N elements, and its
    keyword arguments."""
    K = 41
    kern = (np.hanning(K) * np.sin(2 * np.pi * 5e6 * np.arange(K) / FS)).astype(np.float32)
    pn = np.stack([np.linspace(-19e-3, 19e-3, N), np.zeros(N), np.zeros(N)],
                  -1)[:, None, :].astype(np.float32)
    ps = np.stack([rng.uniform(-15e-3, 15e-3, S), np.zeros(S),
                   rng.uniform(15e-3, 45e-3, S)], -1).astype(np.float32)
    s0 = 2 * 14e-3 / C0
    T = int(np.ceil((2 * 50e-3 / C0 - s0) * FS))
    kw = dict(T=T, s0=s0, t0k=-K / 2 / FS, fs=FS, cinv=1 / C0, R0=1e-3)
    return kern, ps, np.ones(S, np.float32), pn, pn.copy(), kw


def greens_clouds(N, p_max):
    """The greens sweep's problems in its order: (S, problem) for S = 2^4,
    2^6, ..., 2^p_max, drawn from one generator of seed 0."""
    rng = np.random.default_rng(0)
    for p in range(4, p_max + 1, 2):
        yield 2 ** p, greens_problem(2 ** p, N, rng)


def greens_traces(impl, kern, ps, amp, pn, pv, dev, **kw):
    """One engine's traces: 'freq' (K3), 'pallas' (K5) or 'splat'."""
    if impl == "freq":
        return ops.greens_freq(kern, ps, amp, pn, pv, device=dev, **kw)
    if impl == "pallas":
        return ops.greens_tiled(kern, ps, amp, pn, pv, method="linear", device=dev, **kw)
    return ops.greens_splat(kern, ps, amp, pn, pv, method="linear", block=256, device=dev,
                            **kw)


def bench_greens(dev, out):
    """greens us/scatterer: 2^4..2^20 diffuse scatterers, 128 x 128
    elements (``ParTest.m:272-284``); stops at the time budget. 'freq' is
    K3 and 'pallas' K5 on the card; 'freq' and 'splat' on the CPU."""
    N = M = 16 if _tiny() else 128
    impls = ("freq", "pallas") if dev.type == "cuda" else ("freq", "splat")
    only = os.environ.get("QUPS_BENCH_IMPL")
    if only:
        if only not in impls:
            raise SystemExit(f"QUPS_BENCH_IMPL={only!r} is not available on this "
                             f"device (choices: {impls})")
        impls = (only,)
    start = time.time()
    for S, (kern, ps, amp, pn, pv, kw) in greens_clouds(N, 8 if _tiny() else 20):
        if time.time() - start > _budget():
            break
        for impl in impls:
            try:
                dt = timed(lambda: _total(greens_traces(impl, kern, ps, amp, pn, pv, dev,
                                                        **kw)), 1)[0]
            except Exception as e:  # a configuration's failure is a line; the sweep goes on
                _fail(out, {"bench": "greens", "impl": impl, "S": S}, e)
                continue
            _emit(out, {"bench": "greens", "metric": "us/scatterer", "impl": impl, "S": S,
                        "value": dt / S * 1e6, "s_total": dt, "N": N, "M": M, "T": kw["T"]})


# ------------------------------------------------------------------- lut
def lut_tables(N, M, n, dev):
    """The lut bench's plane-wave delay tables (I, N), (I, M), made on
    ``dev`` once, and its t0."""
    pr, pv, nv, t0 = sweep_geometry(N, M)
    tau_rx, tau_tx = ops.delay_tables(pixels(n), pr, pv, nv, C0, tx_model="plane",
                                      device=dev)
    return tau_rx, tau_tx, t0


def bench_lut(dev, out):
    """Delay-table DAS at the headline (the ``bfDAS``/``bfDASLUT``/
    ``bfEikonal`` spine, ``UltrasoundSystem.m:4476-4673``): 1024^2 px from
    256 x 256 tx/rx tables, T 4096, linear and cubic, on K2; the tables
    live on the card, made once."""
    T, N, M = (256, 16, 4) if _tiny() else (4096, 256, 256)
    n = 128 if _tiny() else 1024
    x = traces((T, N, M), dev)
    tau_rx, tau_tx, t0 = lut_tables(N, M, n, dev)
    prec = os.environ.get("QUPS_BENCH_PRECISION", "f32")
    for method in ("linear", "cubic"):
        try:
            dt = timed(lambda: _total(ops.das_lut_sum(
                x, tau_rx, tau_tx, t0, fs=FS, method=method, im_shape=(n, n, 1),
                precision=prec)), 1)[0]
        except Exception as e:  # a configuration's failure is a line; the sweep goes on
            _fail(out, {"bench": "lut", "method": method}, e)
            continue
        _emit(out, {"bench": "lut", "metric": "s/frame", "method": method, "value": dt,
                    "sums_per_s": n * n * N * M / dt, "n_px_side": n, "T": T, "N": N,
                    "M": M, "precision": prec})


# ----------------------------------------------------------------- focus
def focus_problem(T, N, M, dev):
    """The focus bench's FSA system, traces on ``dev`` and its sequence of
    ``Mp`` foci at 30 mm."""
    xdc = qt.TransducerArray(numel=M, pitch=0.2e-3, fc=5e6)
    chd = qt.ChannelData(data=traces((T, N, M), dev), fs=FS, t0=0.0)
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc,
                             seq=qt.Sequence(type="FSA", numpulse=M, c0=C0),
                             scan=qt.ScanCartesian(x=np.linspace(-1e-2, 1e-2, 4),
                                                   z=np.linspace(1e-2, 3e-2, 4)),
                             fs=FS)

    def seq(Mp):
        foc = np.stack([np.linspace(-10e-3, 10e-3, Mp), np.zeros(Mp), np.full(Mp, 30e-3)], 0)
        return qt.Sequence(type="FC", focus=foc, c0=C0)
    return us, chd, seq


def bench_focus(dev, out):
    """focusTx (``interpd.cu:345-396``, ``UltrasoundSystem.m:3374-3503``):
    M' = 128 focused transmits and one walking-aperture line synthesized
    from a (4096, 128, 128) FSA set; method 'auto' is 'freq' on the card."""
    T, N, M = (256, 16, 16) if _tiny() else (4096, 128, 128)
    us, chd, seq = focus_problem(T, N, M, dev)
    meth = os.environ.get("QUPS_BENCH_FOCUS_METHOD", "auto")
    for Mp in (M, 1):
        try:
            dt = timed(lambda: _total(us.focusTx(chd, seq(Mp), method=meth, device=dev).data),
                       1)[0]
        except Exception as e:  # a configuration's failure is a line; the sweep goes on
            _fail(out, {"bench": "focus", "Mp": Mp}, e)
            continue
        _emit(out, {"bench": "focus", "metric": "s/focus-synthesis", "value": dt, "T": T,
                    "N": N, "M": M, "Mp": Mp, "method": meth,
                    "resamples_per_s": T * N * M * Mp / dt})


# ------------------------------------------------------------- coherence
def coherence_image(x, pi, n, which, precision="f32"):
    """keep_rx DAS (linear) of traces ``x (T, N, M)`` at the n x n pixels
    ``pi``, then cohfac or slsc (lags max(2, N // 8)) over the receivers."""
    N = x.shape[1]
    brx = das_image(x, pi, n, keep_rx=True, precision=precision)[..., 0]
    if which == "cohfac":
        return ops.cohfac(brx, axis=1)
    return ops.slsc(brx, axis=1, lags=max(2, N // 8))


def bench_coherence(dev, out):
    """Coherence imaging: keep_rx DAS (K1(c), the rx axis kept) and the
    cohfac / slsc aperture reductions, the BASELINE config-5 workload
    (reference: ``kern/slsc.m``, ``kern/cohfac.m``). QUPS_BENCH_SIZE=full
    runs the 1024^2 x 256 x 256 headline."""
    full = os.environ.get("QUPS_BENCH_SIZE") == "full"
    T, N, M = (512, 16, 4) if _tiny() else ((4096, 256, 256) if full else (2048, 128, 64))
    n = 128 if _tiny() else (1024 if full else 512)
    x, pi = traces((T, N, M), dev), pixels(n)
    prec = os.environ.get("QUPS_BENCH_PRECISION", "f32")
    for name in ("cohfac", "slsc"):
        try:
            dt = timed(lambda: _total(coherence_image(x, pi, n, name, prec)), 1)[0]
        except Exception as e:  # a configuration's failure is a line; the sweep goes on
            _fail(out, {"bench": "coherence", "which": name}, e)
            continue
        _emit(out, {"bench": "coherence", "which": name,
                    "metric": "s/frame (keep_rx DAS + reduction)", "value": dt,
                    "sums_per_s": n * n * N * M / dt, "n_px_side": n, "T": T, "N": N,
                    "M": M, "precision": prec})


# --------------------------------------------------------------- adjoint
def adjoint_problem(x, n, nb):
    """The adjoint bench's FSA system of the traces ``x (T, N, M)`` on n x n
    pixels, and ``nb`` bins around fc."""
    T, N, M = x.shape
    fc = 5e6
    xdc = qt.TransducerArray(numel=N, pitch=0.2e-3, fc=fc)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=M, c0=C0),
        scan=qt.ScanCartesian(x=np.linspace(-12e-3, 12e-3, n), z=np.linspace(5e-3, 45e-3, n)),
        fs=FS)
    chd = qt.ChannelData(data=x, fs=FS, t0=0.0)
    k0 = int(round(fc / FS * T))
    return us, chd, np.arange(k0 - nb // 2, k0 + nb - nb // 2, dtype=np.int32)


def bench_adjoint(dev, out):
    """bfAdjoint at the headline (1024^2 px from 256 x 256 tx/rx, T 4096),
    64 bins around fc (``UltrasoundSystem.m:3770-4050``): K4 with bf16
    operands, the port's default. QUPS_BENCH_ADJ_BINS caps the bins."""
    T, N, M = (256, 16, 16) if _tiny() else (4096, 256, 256)
    n = 64 if _tiny() else 1024
    nb = int(os.environ.get("QUPS_BENCH_ADJ_BINS", "16" if _tiny() else "64"))
    kern = os.environ.get("QUPS_BENCH_ADJ_KERNEL", "auto")
    try:
        us, chd, bins = adjoint_problem(traces((T, N, M), dev), n, nb)
        dt = timed(lambda: _total(us.bfAdjoint(chd, bins=bins, kernel=kern, device=dev)),
                   1)[0]
    except Exception as e:  # the failure is a line
        _fail(out, {"bench": "adjoint"}, e)
        return
    _emit(out, {"bench": "adjoint", "metric": "s/frame", "value": dt, "n_px_side": n,
                "T": T, "N": N, "M": M, "bins": int(bins.size), "kernel": kern,
                "pix_bins_per_s": n * n * bins.size / dt})


# --------------------------------------------------------------- refocus
def hadamard(n):
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


def refocus_problem(T, N, M, dev):
    """The refocus bench's FSA system, traces on ``dev`` and its Hadamard
    encoding."""
    xdc = qt.TransducerArray(numel=M, pitch=0.2e-3, fc=5e6)
    us = qt.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=qt.Sequence(type="FSA", numpulse=M, c0=C0),
        scan=qt.ScanCartesian(x=[0.0], z=[20e-3]), fs=FS)
    enc = qt.Sequence(type="FSA", numpulse=M, c0=C0, apd=hadamard(M), del_=np.zeros((M, M)))
    return us, qt.ChannelData(data=traces((T, N, M), dev), fs=FS, t0=0.0), enc


def bench_refocus(dev, out):
    """refocus (REFoCUS decoding, ``UltrasoundSystem.m:3505-3768``): a
    Hadamard-encoded (4096, 256, 256) set decoded back to FSA, gamma 0,
    cold (the operator cache cleared: build + apply) and with the cached
    operator on a second frame."""
    T, N, M = (256, 16, 16) if _tiny() else (4096, 256, 256)
    try:
        us, chd, enc = refocus_problem(T, N, M, dev)

        def run(c):
            return _total(us.refocus(c, enc, gamma=0.0, device=dev).data)
        run(chd)
        system._REFOCUS_OP_CACHE.clear()
        t = time.time()
        run(chd)
        dt = time.time() - t
        chd2 = chd.replace(data=chd.data * 0.5)
        t = time.time()
        run(chd2)
        dt2 = time.time() - t
    except Exception as e:  # the failure is a line
        _fail(out, {"bench": "refocus"}, e)
        return
    _emit(out, {"bench": "refocus", "metric": "s/decode", "value": dt,
                "s_per_decode_cached_op": dt2, "T": T, "N": N, "M": M,
                "resamples_per_s": T * N * M * M / dt})


# ------------------------------------------------------------------ fdtd
def fdtd_problem(n, steps):
    """The fdtd bench's homogeneous maps, source and keyword arguments."""
    h = 0.2e-3
    dt = 0.3 * h / 1500.0
    t = np.arange(steps) * dt
    sig = (np.sin(2 * np.pi * 2e6 * t)
           * np.exp(-((t - 1e-6) / 0.5e-6) ** 2))[:, None].astype(np.float32)
    maps = (np.full((n, n), 1500.0, np.float32), np.full((n, n), 1000.0, np.float32))
    src = (np.array([20]), np.array([n // 2]))
    return maps, src, sig, dict(steps=steps, dt=dt, dx=h, c_ref=1500.0,
                                record_rows=(n - 20,))


def bench_fdtd(dev, out):
    """k-space stepper ms/step on a 225^2 grid, 400 steps
    (``ParTest.m:298-318``)."""
    n = 64 if _tiny() else 225
    steps = 50 if _tiny() else 400
    try:
        maps, src, sig, kw = fdtd_problem(n, steps)
        dtw = timed(lambda: _total(kspace_sim_2d(*maps, *src, sig, device=dev, **kw)), 1)[0]
    except Exception as e:  # the failure is a line
        _fail(out, {"bench": "fdtd"}, e)
        return
    _emit(out, {"bench": "fdtd", "metric": "ms/step", "grid": [n, n], "steps": steps,
                "value": dtw / steps * 1e3, "s_total": dtw})


# --------------------------------------------------------------- eikonal
def eikonal_speed(n):
    """The eikonal bench's n x n speed map: 1650 m/s below a third."""
    F = np.full((n, n), 1540.0)
    F[n // 3:, :] = 1650.0
    return F, np.array([[0, n // 2]])


def bench_eikonal(dev, out):
    """MSFM travel-time maps, ms/map vs grid size (the bfEikonal delay
    backbone): the port's host C++ solver, on the host whatever ``dev``."""
    t_stop = time.time() + _budget()
    for n in (64, 128) if _tiny() else (128, 256, 512, 1024):
        if time.time() > t_stop:
            _emit(out, {"bench": "eikonal", "skipped": n, "reason": "budget"})
            break
        try:
            F, src = eikonal_speed(n)
            ops.msfm(F, 0.2e-3, src)  # the solver's first load
            reps = 3
            t = time.time()
            for _ in range(reps):
                ops.msfm(F, 0.2e-3, src)
            dt = (time.time() - t) / reps
        except Exception as e:  # a configuration's failure is a line; the sweep goes on
            _fail(out, {"bench": "eikonal", "grid": [n, n]}, e)
            continue
        _emit(out, {"bench": "eikonal", "metric": "ms/map", "grid": [n, n],
                    "value": dt * 1e3, "cells_per_s": n * n / dt})


# ------------------------------------------------------------- migration
def migration_image(x):
    """Stolt migration of plane-wave traces ``x (T, N, M)``, M angles over
    +-9 degrees, complex64."""
    M = x.shape[2]
    return ops.stolt_migration(x, 0.0, np.zeros((x.shape[1], M), np.float32),
                               tuple(np.linspace(-9.0, 9.0, M)), fs=FS, c0=C0,
                               pitch=0.15e-3, device=x.device)


def bench_migration(dev, out):
    """Stolt f-k migration s/frame at the plane-wave headline
    (``UltrasoundSystem.m:4740-4860``), 3 repetitions."""
    T, N, M = (512, 64, 4) if _tiny() else (4096, 256, 16)
    try:
        x = traces((T, N, M), dev)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        migration_image(x)
        sync()
        reps = 3
        t = time.time()
        for _ in range(reps):
            migration_image(x)
        sync()
        dt = (time.time() - t) / reps
    except Exception as e:  # the failure is a line
        _fail(out, {"bench": "migration"}, e)
        return
    _emit(out, {"bench": "migration", "metric": "s/frame", "shape": [T, N, M], "value": dt,
                "pix_tx_per_s": T * N * M / dt})


BENCHES = {"das": bench_das, "greens": bench_greens, "coherence": bench_coherence,
           "lut": bench_lut, "focus": bench_focus, "adjoint": bench_adjoint,
           "refocus": bench_refocus, "fdtd": bench_fdtd, "eikonal": bench_eikonal,
           "migration": bench_migration}


def run(which="all", device=None) -> list:
    """Run the bench ``which`` (or all, in the JAX file's order) on
    ``device``; returns every line printed, as dicts."""
    dev = default_device(device)
    out = []
    for name, fn in BENCHES.items():
        if which in (name, "all"):
            fn(dev, out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's benchmark sweeps")
    ap.add_argument("which", nargs="?", default="all", choices=[*BENCHES, "all"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    errors = [r for r in run(args.which, args.device) if "error" in r]
    for r in errors:
        print(f"benches: {r['bench']} failed: {r['error']}", file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
