"""Display helpers on matplotlib.

Port of :mod:`qups_tpu.display`: the reference's visualisation surface
(``ChannelData.imagesc/gif`` ``src/ChannelData.m:1497-1640``, ``Scan.plot/
imagesc/gif`` ``src/Scan.m:288-593``, ``Medium.imagesc`` ``src/Medium.m:701``,
``Transducer.plot`` ``src/Transducer.m:992-1123``), bound as methods of the
port's objects when the package is imported. Every function takes an
optional ``ax`` and returns the artist; the animations return a
``matplotlib.animation.FuncAnimation`` (``anim.save(path, writer='pillow')``).
Tensors on any device are copied to the host; images are shown as a
log envelope through :func:`qups_tpu_torch.utils.mod2db`. ``matplotlib`` is
imported inside the functions, so the package imports without it.

Two differences from the JAX package, both intended: a trailing size-2 axis
of a real image is a second frame unless ``ri=True`` asks to join it as a
real/imaginary pair (the JAX package joins it by default, a convention of
its TPU output format); and ``chd_imagesc`` labels time with transmit
``m``'s own axis where ``t0`` differs per transmit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .core.channel_data import ChannelData
from .core.medium import Medium
from .core.scan import Scan, ScanCartesian, ScanPolar
from .core.scat import Scatterers
from .core.xdc import Transducer
from .utils.backend import to_host
from .utils.maths import mod2db


def _get_ax(ax=None):
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    return ax


def _host_abs(x):
    return np.abs(to_host(x))


def _db(x):
    """``mod2db`` of a host array, as host numpy."""
    return to_host(mod2db(x))


def _image_host(b, ri=None):
    """A beamformed image as host numpy. ``ri=True`` joins a trailing
    size-2 axis of a real image as a real/imaginary pair; otherwise the
    image is taken as it is (the port's beamformers return complex images,
    never pairs, so a trailing size-2 axis is two frames)."""
    x = to_host(b)
    if ri and not np.iscomplexobj(x):
        x = x[..., 0] + 1j * x[..., 1]
    return x


def _tx_time(chd: ChannelData, m: int, frame: int) -> np.ndarray:
    """Transmit ``m``'s time axis (s) of frame ``frame``: ``chd.time`` at
    receiver 0, taken along each axis where it varies."""
    t = to_host(chd.time)[:, 0]
    t = t[:, m if t.shape[1] > 1 else 0]
    while t.ndim > 1:
        t = t[..., frame if t.shape[-1] > 1 else 0]
    return t


# --------------------------------------------------------------------- data
def chd_imagesc(chd: ChannelData, m: int = 0, frame: int = 0, ax=None,
                db: bool = False, **imshow_kw):
    """Display one transmit's channel traces (time x rx), the
    ``ChannelData.imagesc`` analog (``src/ChannelData.m:1497``); the time
    axis is transmit ``m``'s."""
    ax = _get_ax(ax)
    x = to_host(chd.data)
    while x.ndim > 3:
        x = x[..., frame]
    img = x[:, :, m]
    if db or np.iscomplexobj(img):
        img = _db(np.abs(img) + 1e-30)
        imshow_kw.setdefault("vmin", float(img.max()) - 60)
    t = _tx_time(chd, m, frame)
    h = ax.imshow(np.real(img), aspect="auto", origin="upper",
                  extent=[0.5, img.shape[1] + 0.5, t[-1] * 1e6, t[0] * 1e6],
                  **imshow_kw)
    ax.set_xlabel("receive element")
    ax.set_ylabel("time [us]")
    return h


def chd_gif(chd: ChannelData, ax=None, db: bool = True, interval: int = 100):
    """Animate the transmits of a ChannelData (``ChannelData.gif``,
    ``src/ChannelData.m:1575-1640``). Returns a FuncAnimation."""
    from matplotlib import animation
    ax = _get_ax(ax)
    h = chd_imagesc(chd, 0, ax=ax, db=db)
    x = to_host(chd.data)
    while x.ndim > 3:
        x = x[..., 0]

    def update(m):
        img = x[:, :, m]
        if db or np.iscomplexobj(img):
            img = _db(np.abs(img) + 1e-30)
        h.set_data(np.real(img))
        return (h,)

    return animation.FuncAnimation(ax.figure, update, frames=chd.M,
                                   interval=interval, blit=True)


# -------------------------------------------------------------------- image
def scan_imagesc(scan: Scan, b, ax=None, dbr: Optional[float] = 60.0,
                 slice: Optional[str] = None, index: int = 0,
                 ri=None, **imshow_kw):
    """Display a beamformed image on its scan's axes (``Scan.imagesc``,
    ``src/Scan.m:288``): cartesian scans use the physical extent; polar
    scans are scan-converted first. ``dbr``: dynamic range in dB (None for
    linear amplitude). For VOLUMES, ``slice``/``index`` pick the plane to
    display (an axis letter of ``scan.order``, default Y, ``Scan.m:385-406``).
    Frames beyond the scan's dims: the first is shown. ``ri=True`` joins a
    trailing size-2 axis of real data as a real/imaginary pair."""
    ax = _get_ax(ax)
    img = _image_host(b, ri=ri)
    img = img.reshape(tuple(scan.shape) + (-1,))[..., 0]
    if isinstance(scan, ScanCartesian) and scan.ny > 1:
        # volumetric: slice along the named (default elevational) axis and
        # display the remaining plane, each kept axis labeled by its letter
        order = scan.order
        sdim = order.index(slice.upper()) if slice else order.index("Y")
        img = np.take(img, index, axis=sdim)
        keep = [c for i, c in enumerate(order) if i != sdim]
        axv = {c: np.asarray(getattr(scan, c.lower())) * 1e3 for c in keep}
        ext = [axv[keep[1]][0], axv[keep[1]][-1],
               axv[keep[0]][-1], axv[keep[0]][0]]
        return _imshow_db(ax, _host_abs(img), ext, dbr,
                          keep[1].lower() + " [mm]",
                          keep[0].lower() + " [mm]", **imshow_kw)
    if isinstance(scan, ScanPolar):
        img2, scan_c = scan.scan_convert(_host_abs(img))
        img2 = np.nan_to_num(to_host(img2))
        return scan_imagesc(scan_c, img2, ax=ax, dbr=dbr, **imshow_kw)
    elif isinstance(scan, ScanCartesian):
        zdim = scan.order.index("Z")
        xdim = scan.order.index("X")
        dat = _host_abs(np.squeeze(img))
        if xdim < zdim:
            dat = dat.T
        ext = [scan.x[0] * 1e3, scan.x[-1] * 1e3,
               scan.z[-1] * 1e3, scan.z[0] * 1e3]
    else:
        raise TypeError(f"unsupported scan type {type(scan).__name__}")
    return _imshow_db(ax, dat, ext, dbr, "x [mm]", "z [mm]", **imshow_kw)


def _imshow_db(ax, dat, ext, dbr, xlabel, ylabel, **imshow_kw):
    """Shared imshow with optional dB compression and mm-axis labels."""
    if dbr is not None:
        dat = _db(dat + 1e-30)
        imshow_kw.setdefault("vmax", float(np.nanmax(dat)))
        imshow_kw.setdefault("vmin", imshow_kw["vmax"] - dbr)
        imshow_kw.setdefault("cmap", "gray")
    h = ax.imshow(dat, extent=ext, origin="upper", aspect="equal",
                  **imshow_kw)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return h


def scan_plot(scan: Scan, ax=None, **plot_kw):
    """Plot the scan's pixel lattice (``Scan.plot``)."""
    ax = _get_ax(ax)
    P = scan.positions().reshape(3, -1)
    plot_kw.setdefault("marker", ".")
    plot_kw.setdefault("linestyle", "none")
    plot_kw.setdefault("markersize", 1)
    h, = ax.plot(P[0] * 1e3, P[2] * 1e3, **plot_kw)
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("z [mm]")
    ax.invert_yaxis()
    return h


def scan_vol3d(scan: Scan, b, axs=None, dbr: Optional[float] = 60.0,
               mode: str = "mip", ri=None, **imshow_kw):
    """3-D volume display (``Scan.vol3d``, ``src/Scan.m:512-562``):
    maximum-intensity projections along each scan axis (``mode='mip'``,
    one subplot per projection) or an alpha-composited stack of the
    elevational planes (``mode='alpha'``). Returns the list of image
    handles."""
    import matplotlib.pyplot as plt

    assert isinstance(scan, ScanCartesian), "vol3d expects a cartesian scan"
    vol = np.abs(_image_host(b, ri=ri).reshape(
        tuple(scan.shape) + (-1,))[..., 0])
    if dbr is not None:
        vol = _db(vol + 1e-30)
        vmax = float(np.nanmax(vol))
        imshow_kw.setdefault("vmax", vmax)
        imshow_kw.setdefault("vmin", vmax - dbr)
        imshow_kw.setdefault("cmap", "gray")
    order = scan.order
    axvals = {c: np.asarray(getattr(scan, c.lower())) * 1e3 for c in "XYZ"}
    if mode == "alpha":
        first = axs[0] if isinstance(axs, (list, tuple, np.ndarray)) else axs
        ax = _get_ax(first)
        ydim = order.index("Y")
        ny = vol.shape[ydim]
        lo, hi = imshow_kw.get("vmin", vol.min()), imshow_kw.get(
            "vmax", vol.max())
        hs = []
        for i in range(ny):
            pl = np.take(vol, i, axis=ydim)
            a = np.clip((pl - lo) / max(hi - lo, 1e-30), 0, 1)
            h = ax.imshow(pl, alpha=np.clip(0.9 * a * 4 / ny, 0.0, 1.0),
                          aspect="equal", **imshow_kw)
            hs.append(h)
        return hs
    if axs is None:
        _, axs = plt.subplots(1, 3, figsize=(12, 4))
    hs = []
    for k, proj in enumerate("YXZ"):  # z-x (en face), z-y, x-y planes
        pdim = order.index(proj)
        mip = vol.max(axis=pdim)
        keep = [c for i, c in enumerate(order) if i != pdim]
        ext = [axvals[keep[1]][0], axvals[keep[1]][-1],
               axvals[keep[0]][-1], axvals[keep[0]][0]]
        h = axs[k].imshow(mip, extent=ext, origin="upper", aspect="equal",
                          **imshow_kw)
        axs[k].set_xlabel(f"{keep[1].lower()} [mm]")
        axs[k].set_ylabel(f"{keep[0].lower()} [mm]")
        axs[k].set_title(f"MIP over {proj.lower()}")
        hs.append(h)
    return hs


def image_gif(scan: Scan, frames, ax=None, dbr: float = 60.0,
              interval: int = 100):
    """Animate a stack of beamformed images (last axis = frame) on a scan
    (``Scan.gif``, ``src/Scan.m:423``)."""
    from matplotlib import animation
    ax = _get_ax(ax)
    fr = to_host(frames)
    h = scan_imagesc(scan, fr[..., 0], ax=ax, dbr=dbr)

    def update(i):
        img = _host_abs(fr[..., i]).squeeze()
        h.set_data(_db(img + 1e-30))
        return (h,)

    return animation.FuncAnimation(ax.figure, update, frames=fr.shape[-1],
                                   interval=interval, blit=True)


# ------------------------------------------------------------------- medium
def medium_imagesc(med: Medium, scan: Scan, prop: str = "c", ax=None,
                   **imshow_kw):
    """Display a Medium property map sampled on a scan (``Medium.imagesc``,
    ``src/Medium.m:701``)."""
    ax = _get_ax(ax)
    m = med.props(scan, prop)
    return scan_imagesc(scan, m, ax=ax, dbr=None, **imshow_kw)


# ---------------------------------------------------------------- transducer
def xdc_plot(xdc: Transducer, ax=None, **plot_kw):
    """Plot element positions and normals (``Transducer.plot``,
    ``src/Transducer.m:992``)."""
    ax = _get_ax(ax)
    p = xdc.positions()
    _, _, n, _, _ = xdc.orientations()
    plot_kw.setdefault("marker", "s")
    plot_kw.setdefault("linestyle", "none")
    h, = ax.plot(p[0] * 1e3, p[2] * 1e3, **plot_kw)
    L = xdc.width * 2e3
    for i in range(0, xdc.numel, max(1, xdc.numel // 16)):
        ax.plot([p[0, i] * 1e3, p[0, i] * 1e3 + L * n[0, i]],
                [p[2, i] * 1e3, p[2, i] * 1e3 + L * n[2, i]],
                color=h.get_color(), linewidth=0.5)
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("z [mm]")
    return h


def scat_plot(scat: Scatterers, ax=None, **plot_kw):
    """Plot scatterer positions (``Scatterers.plot``)."""
    ax = _get_ax(ax)
    plot_kw.setdefault("marker", "o")
    plot_kw.setdefault("linestyle", "none")
    h, = ax.plot(scat.pos[0] * 1e3, scat.pos[2] * 1e3, **plot_kw)
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("z [mm]")
    ax.invert_yaxis()
    return h


# bound as methods, as the reference exposes them on the objects
ChannelData.imagesc = chd_imagesc
ChannelData.gif = chd_gif
Scan.imagesc = scan_imagesc
Scan.plot = scan_plot
Scan.gif = image_gif
Medium.imagesc = medium_imagesc
Transducer.plot = xdc_plot
Scatterers.plot = scat_plot
