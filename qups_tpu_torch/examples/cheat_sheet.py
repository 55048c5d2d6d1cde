"""qups_tpu_torch cheat sheet: an executable tour of the port's API, the
port of ``examples/cheat_sheet.py`` (the reference's ``cheat_sheet.m`` /
``example_.m``). Sizes are small, so it runs in seconds on the CPU; every
call takes ``device=``, and the mesh blocks run on a one-device mesh of
that device (``make_mesh([device])``; list more devices to shard).

Runs on the card by default:

    python -m qups_tpu_torch.examples.cheat_sheet            # CUDA
    python -m qups_tpu_torch.examples.cheat_sheet --device cpu
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import tempfile

import numpy as np
import torch

import qups_tpu_torch as qt
from qups_tpu_torch import interop
from qups_tpu_torch.io import load_checkpoint, save_checkpoint
from qups_tpu_torch.parallel import (das_sharded, das_sharded_pallas, fdtd_sharded,
                                     make_mesh, refocus_sharded)
from qups_tpu_torch.utils import Timer
from qups_tpu_torch.utils.backend import default_device

C0 = 1540.0


def system():
    """The cheat sheet's system: a 16-element linear array at 5 MHz, three
    plane waves over +-10 degrees, 64 x 64 pixels, fs 25 MHz; and the
    sequences, the target and the layered medium it uses."""
    xdc = qt.TransducerArray(numel=16, pitch=0.3e-3, fc=5e6)
    ang = np.radians([-10.0, 0.0, 10.0])
    seq_pw = qt.Sequence(type="PW", focus=np.stack([np.sin(ang), 0 * ang, np.cos(ang)]), c0=C0)
    scan = qt.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 64), y=[0.0],
                            z=np.linspace(12e-3, 24e-3, 64))
    us = qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq_pw, scan=scan, fs=25e6)
    scat = qt.Scatterers(pos=np.array([[0.0], [0.0], [18e-3]]), c0=C0)
    return us, scat


def main(device=None) -> dict:
    """Run the tour on ``device`` (None: the CUDA device). Returns the
    system, the traces, the images by name and the sharded results by
    function name."""
    dev = default_device(device)
    # ----------------------------------------------------------- definitions
    # Transducers: linear / convex / matrix / generic (+ named presets)
    _ = qt.TransducerArray.L11_5v()
    _ = qt.TransducerConvex(numel=16, radius=40e-3, fc=3e6)
    _ = qt.TransducerMatrix(numd=(4, 4), pitch2=(0.3e-3, 0.3e-3), fc=3e6)
    us, scat = system()
    xdc, seq_pw, scan = us.tx, us.seq, us.scan
    # Sequences: FSA / PW / FC (+ custom delays and apodization)
    seq_fsa = qt.Sequence(type="FSA", numpulse=xdc.numel, c0=C0)
    seq_fc = qt.Sequence(type="FC", focus=np.array(
        [[-2e-3, 0.0, 2e-3], [0, 0, 0], [20e-3, 20e-3, 20e-3]]), c0=C0)
    # Media: a layer of 1600 m/s below 20 mm
    med = qt.Medium(c0=C0, rho0=1000.0, pertreg=((lambda P: P[2] > 20e-3, {"c": 1600.0}),))

    # ------------------------------------------------------------ simulation
    chd = us.greens(scat, device=dev)                  # Green's function + focusTx
    print("ChannelData:", tuple(chd.data.shape), "fs =", chd.fs)
    _ = us.greens(scat, precision="bf16", device=dev)  # bf16 GEMM operands (freq)
    chd_s = us.simus(scat, device=dev)                 # with element directivity
    print("simus:", tuple(chd_s.data.shape))
    pmax = us.replace(seq=seq_fc).calc_hp(device=dev)  # transmit pressure map
    print("pressure map:", tuple(pmax.shape))

    # ------------------------------------------------------------------- DSP
    chd2 = chd.hilbert().downmix(us.fc).resample(12.5e6)  # analytic, baseband, half rate

    # ----------------------------------------------------------- beamforming
    imgs = {"DAS": us.DAS(chd, method="linear", device=dev),   # K1 on the card
            "bfDAS": us.bfDAS(chd, device=dev),                # delay tables, K2
            "bfAdjoint": us.bfAdjoint(chd, max_bins=24, device=dev)}  # frequency domain, K4
    imgs["bfMigration"], _ = us.bfMigration(chd, device=dev)  # Stolt f-k (PW only)
    tau_rx, tau_tx = us.das_delay_tables(device=dev)
    imgs["bfDASLUT"] = us.bfDASLUT(chd, tau_rx, tau_tx, device=dev)  # your own delays
    imgs["IQ"] = us.DAS(chd2, fmod=us.fc, method="linear", device=dev)

    # apodization: dense generators, or fused descriptors evaluated in K1
    _ = us.ap_aperture_growth(f=1.5)
    imgs["fused"] = us.DAS(chd, apod=(qt.Fused("aperture_growth", f=1.5),), method="linear",
                           device=dev)

    # coherence imaging on a receive-kept image, or in one call
    brx = us.DAS(chd, keep_rx=True, method="linear", device=dev)
    cf = qt.ops.cohfac(brx, axis=-2)
    imgs["coherence"] = us.coherence_image(chd, post="cohfac", method="linear", device=dev)
    imgs["slsc"] = us.coherence_image(chd, post="slsc", lags=3, method="linear", device=dev)
    print("images:", tuple(imgs["DAS"].shape), "coherence:", tuple(cf.shape))

    # ---------------------------------------------------- heterogeneous medium
    cgrd = qt.ScanCartesian(x=np.arange(-4e-3, 4e-3, 0.2e-3), y=[0.0],
                            z=np.arange(0.0, 26e-3, 0.2e-3))
    imgs["bfEikonal"] = us.bfEikonal(chd, med, cgrd, device=dev)  # eikonal travel times
    print("eikonal image:", tuple(imgs["bfEikonal"].shape))

    # ------------------------------------------------------ out-of-core / tall
    b8 = us.DAS(chd, method="linear", bsize=2, device=dev)  # 2 transmits at a time
    b = imgs["DAS"]
    assert float((b8 - b).abs().max()) <= 1e-5 * float(b.abs().max())

    # ---------------------------------------------- full-wave sim (k-Wave-y)
    cgrd2 = qt.ScanCartesian(x=np.arange(-3e-3, 3e-3, 0.3e-3), y=[0.0],
                             z=np.arange(-0.5e-3, 8e-3, 0.3e-3))
    us_kw = us.replace(scan=qt.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                             z=np.linspace(1e-3, 6e-3, 8)))
    chd_kw, fields = us_kw.kspaceFirstOrder(qt.Medium(c0=C0, rho0=1000.0), cgrd2,
                                            record="field", field_stride=16, tmax=4e-6,
                                            device=dev)
    print("fdtd traces:", tuple(chd_kw.data.shape), "field snapshots:", tuple(fields.shape))

    # -------------------------------------------------------------- profiling
    tm = Timer()
    with tm("das"):
        _ = us.DAS(chd, method="linear", device=dev)
    print("DAS wall:", round(tm.times["das"], 3), "s")

    # ---------------------------------------------------------- serialization
    with tempfile.TemporaryDirectory() as d:
        if importlib.util.find_spec("h5py") is not None:  # UFF needs h5py
            interop.save_uff(os.path.join(d, "demo.uff"), chd=chd, xdc=xdc, seq=seq_pw,
                             scan=scan)
            assert interop.load_uff(os.path.join(d, "demo.uff"))["xdc"].numel == xdc.numel
        interop.save_mat(os.path.join(d, "demo.mat"), chd=chd)
        assert interop.load_mat(os.path.join(d, "demo.mat"))["chd"].data.shape == chd.data.shape
        save_checkpoint(os.path.join(d, "ckpt.pt"), {"img": b})
        assert torch.equal(load_checkpoint(os.path.join(d, "ckpt.pt"), like={"img": b})["img"], b)

    # ------------------------------------------------------------ more tools
    # attenuating scatterers (alpha0 [dB/cm/MHz], frequency-domain engine)
    chd_att = us.greens(qt.Scatterers(pos=scat.pos, c0=C0, alpha0=0.5), impl="freq", device=dev)
    assert float(chd_att.data.abs().max()) < float(
        us.greens(scat, impl="freq", device=dev).data.abs().max())
    # transmit synthesis by the per-bin frequency GEMM
    chd_fsa = us.replace(seq=seq_fsa).greens(scat, device=dev)
    enc = us.focusTx(chd_fsa, seq_pw, method="freq", device=dev)
    assert enc.data.shape[2] == seq_pw.num_pulse
    # keep both rx and tx (per-pair images)
    bboth = us.DAS(chd, keep_rx=True, keep_tx=True, method="linear", device=dev)
    assert tuple(bboth.shape[-2:]) == (xdc.numel, seq_pw.num_pulse)
    # walking-aperture focused sequence (per-transmit apodization)
    apd_walk = qt.Sequence.ap_walking(xdc.numel, 8, stride=4)
    _ = qt.Sequence(type="FC", focus=seq_fc.focus_array[:, :apd_walk.shape[1]], c0=C0,
                    apd=apd_walk[:, :seq_fc.num_pulse])
    # explicit float32 traces in K1 ('bf16pair' and 'i8x4' narrow them)
    b_q = us.DAS(chd, method="cubic", precision="f32", device=dev)
    assert bool(b_q.abs().isfinite().all())

    # ---------------------------------------------------- several devices
    # one process drives every device of a mesh; on one device it is a
    # one-shard mesh (list more devices, or one card several times, to shard)
    mesh = make_mesh([dev], axes=("rx",), shape=(1,))
    pv_, nv_, model_ = us._tx_geometry()
    t0 = chd.t0_host.reshape(-1)
    sharded = {}
    sharded["das_sharded"] = das_sharded(
        mesh, chd.data, us._pixels(), us.rx.positions().T, pv_, nv_, t0, 1 / C0,
        fs=float(chd.fs), tx_model=model_, method="linear")
    assert bool(sharded["das_sharded"].isfinite().all())
    # the aperture reduction in the mesh: image-sized sums cross devices
    cfm = das_sharded_pallas(
        mesh, chd.data, us._pixels(), us.rx.positions().T, pv_, nv_, t0, 1 / C0,
        fs=float(chd.fs), tx_model=model_, im_shape=tuple(scan.shape), post="cohfac")
    assert cfm.shape[0] == us._pixels().shape[0] and float(cfm.max()) <= 1.0 + 1e-6
    sharded["das_sharded_pallas"] = cfm
    # the system's entry points take the mesh too
    sharded["greens"] = us.greens(scat, mesh=make_mesh([dev], axes=("rx", "tx"))).data
    sharded["coherence_image"] = us.coherence_image(chd, method="linear",
                                                    mesh=make_mesh([dev], axes=("rx", "tx")))
    # transmit-sharded full-wave simulation
    sig = np.zeros((4, 32, 2), np.float32)
    sig[:, 5, :] = 1.0
    sharded["fdtd_sharded"] = fdtd_sharded(
        make_mesh([dev], axes=("tx",)), np.full((48, 48), 1500.0, np.float32),
        np.full((48, 48), 1000.0, np.float32), np.array([[12, 12], [16, 32]]), sig,
        steps=32, dt=4e-8, dx=2e-4, c_ref=1500.0, record_rows=(40,))
    assert tuple(sharded["fdtd_sharded"].shape) == (4, 32, 1, 48)
    # REFoCUS decode: the operator's bins and the receive channels sharded
    xr = chd.data.real.float() if chd.data.is_complex() else chd.data
    V = xr.shape[2]
    sharded["refocus_sharded"], _ = refocus_sharded(
        make_mesh([dev], axes=("rx",)), xr, np.zeros((V, V), np.float32),
        np.eye(V, dtype=np.float32), np.zeros(V, np.float32), fs=float(chd.fs))
    assert sharded["refocus_sharded"].shape[2] == V

    print("cheat sheet OK")
    return dict(us=us, scat=scat, chd=chd, chd2=chd2, images=imgs, sharded=sharded)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(device=ap.parse_args().device)
