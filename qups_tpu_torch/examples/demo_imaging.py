"""End-to-end imaging demo, the port of ``examples/demo_imaging.py`` (the
analog of the reference's ``example_.m`` walkthrough): define a system,
simulate a point-target phantom, beamform it with four beamformers, save
the figures, and check that each image's peak lies on a target.

Runs headless (matplotlib's Agg backend) on the card by default:

    python -m qups_tpu_torch.examples.demo_imaging            # CUDA
    python -m qups_tpu_torch.examples.demo_imaging --device cpu

Figures land in ``--out`` (default ``demo_out/`` in the working directory).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

import qups_tpu_torch as qt
from qups_tpu_torch.display import chd_imagesc, scan_imagesc
from qups_tpu_torch.utils import to_host


def system() -> qt.UltrasoundSystem:
    """The demo's system: an L11-5v (128 elements), 5 plane waves over
    +-10 degrees, 256 x 256 pixels over x +-12 mm, z 15-35 mm, fs = 4 fc."""
    xdc = qt.TransducerArray.L11_5v()
    seq = qt.SequenceRadial(type="PW", angles=np.arange(-10, 11, 5), c0=1540.0)
    scan = qt.ScanCartesian(x=np.linspace(-12e-3, 12e-3, 256),
                            z=np.linspace(15e-3, 35e-3, 256))
    return qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=4 * xdc.fc)


def phantom() -> qt.Scatterers:
    """A 4 x 5 grid of point targets (the ``Scatterers.Grid`` analog)."""
    Zs, Xs = np.meshgrid(np.linspace(18e-3, 32e-3, 4), np.linspace(-8e-3, 8e-3, 5),
                         indexing="ij")
    pos = np.stack([Xs.ravel(), np.zeros(Xs.size), Zs.ravel()])
    return qt.Scatterers(pos=pos, amp=np.ones(pos.shape[1]), c0=1540.0)


def envelope(b, scan) -> np.ndarray:
    """|image| on the host, (z, x) of the scan."""
    return np.abs(to_host(b)).reshape(tuple(scan.shape) + (-1,))[..., 0, 0]


def main(device=None, out_dir: str = "demo_out") -> dict:
    """Run the demo on ``device`` (None: the CUDA device). Returns the
    system, the phantom, the traces, the images by beamformer, and the
    paths of the two figures written into ``out_dir``. Raises
    ``AssertionError`` if an image's peak lies 1.1 mm or more from every
    target (the BFTest oracle)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    us, scat = system(), phantom()
    scan = us.scan
    chd = us.greens(scat, device=device)                    # (T, N, M)
    print("simulated ChannelData:", tuple(chd.data.shape), "fs", chd.fs,
          "on", chd.data.device)
    figs = [os.path.join(out_dir, "channel_data.png"),
            os.path.join(out_dir, "beamformers.png")]
    fig, ax = plt.subplots(figsize=(5, 4))
    chd_imagesc(chd, m=chd.M // 2, ax=ax)
    fig.savefig(figs[0], dpi=110)
    plt.close(fig)

    imgs = {"DAS": us.DAS(chd, device=device),              # K1 on the card
            "bfDAS": us.bfDAS(chd, device=device),          # delay tables, K2
            "bfAdjoint": us.bfAdjoint(chd, device=device),  # frequency domain, K4
            "coherence": us.coherence_image(chd, device=device)}  # K1(c), cohfac

    fig, axs = plt.subplots(1, 4, figsize=(16, 4))
    for ax, (name, b) in zip(axs, imgs.items()):
        if name == "coherence":
            h = ax.imshow(envelope(b, scan),
                          extent=[scan.x[0] * 1e3, scan.x[-1] * 1e3,
                                  scan.z[-1] * 1e3, scan.z[0] * 1e3],
                          cmap="magma", vmin=0, vmax=1)
            ax.set_xlabel("x [mm]")
            ax.set_ylabel("z [mm]")
        else:
            h = scan_imagesc(scan, b, ax=ax, dbr=50.0)
        ax.set_title(name)
        fig.colorbar(h, ax=ax, shrink=0.8)
    fig.tight_layout()
    fig.savefig(figs[1], dpi=110)
    plt.close(fig)

    # every beamformer puts its global peak on a target (within 1.1 mm)
    P = scan.positions().reshape(3, -1)
    for name, b in imgs.items():
        k = int(envelope(b, scan).argmax())
        d = np.linalg.norm(scat.pos.T[:, None, :] - P[:, k][None, None, :], axis=-1).min()
        print(f"{name:10s} peak-to-nearest-scatterer: {d * 1e3:.2f} mm")
        if d >= 1.1e-3:
            raise AssertionError(f"{name}: peak {d * 1e3:.2f} mm from every target")
    print("demo complete; figures in", out_dir)
    return dict(us=us, scat=scat, chd=chd, images=imgs, figures=figs)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--out", default="demo_out", help="directory for the figures")
    a = ap.parse_args()
    main(device=a.device, out_dir=a.out)
