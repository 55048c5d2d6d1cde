"""Apodization in the port against the JAX package, on the CPU: the seven
``ap_*`` generators and ``Fused.materialize`` (cartesian and polar scans,
planar and convex arrays); ``fused_weights`` with the plain ``das``, the
plain version of kernel K1(d), against ``das_tiled(..., apod=Fused(...),
interpret=True)`` for each fused kind; ``UltrasoundSystem.DAS`` with fused
and dense apodization and every keep mode, and ``bfDAS`` with the keep
modes, against the JAX package's; and the ``bsize`` repair of the
per-transmit ``lat_tx`` of a ``Fused``. Kernel K1(c)/(d) and K2(c) on the
card: test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu.ops.das_pallas import Fused as JFused, das_tiled  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import das_cuda  # noqa: E402
from qups_tpu_torch.system import _slice_tx_apod  # noqa: E402

GENERATORS = ("ap_scanline", "ap_multiline", "ap_translating_aperture", "ap_aperture_growth",
              "ap_tx_parallelogram", "ap_acceptance_angle", "ap_cosine_angle")
CINV = np.float32(1 / 1540.0)


def _system(kind):
    """Small systems of the generators' four geometries: a planar array with
    focused transmits on a cartesian scan, the same with plane waves, and a
    convex array with focused transmits on a polar scan (and on a cartesian
    one)."""
    if kind.startswith("convex"):
        xdc = q.TransducerConvex(numel=16, radius=40e-3, angular_pitch=1.0, fc=3e6)
        a = np.linspace(-6.0, 6.0, 5)
        r = 40e-3 + 25e-3
        foci = np.stack([r * np.sin(np.radians(a)), np.zeros(5),
                         r * np.cos(np.radians(a)) - 40e-3])
        seq = q.Sequence(type="FC", focus=foci, c0=1540.0)
        scan = (q.ScanPolar(origin=xdc.center, r=np.linspace(50e-3, 70e-3, 9),
                            a=np.linspace(-7.0, 7.0, 11))
                if kind == "convex_polar" else
                q.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 11), z=np.linspace(10e-3, 30e-3, 9)))
    else:
        xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
        seq = (q.SequenceRadial(type="PW", angles=np.array([-8.0, 0.0, 8.0]), c0=1540.0)
               if kind == "planar_pw" else
               q.Sequence(type="FC", focus=np.stack([np.linspace(-2e-3, 2e-3, 5), np.zeros(5),
                                                     np.full(5, 20e-3)]), c0=1540.0))
        scan = q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 17), z=np.linspace(10e-3, 30e-3, 9))
    us = q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=12e6)
    return us, from_reference(us)


@pytest.mark.parametrize("kind", ["planar_fc", "planar_pw", "convex_polar", "convex_cart"])
def test_generators_match_reference(kind):
    """Each generator, with default and explicit parameters: the same
    shape, masks bit for bit and weights within 1e-6 (float64 host
    geometry in both, returned as float32)."""
    us, ust = _system(kind)
    calls = {g: [{}] for g in GENERATORS}
    calls["ap_aperture_growth"] += [dict(f=1.0, Dmax=3e-3)]
    calls["ap_acceptance_angle"] += [dict(theta=20.0)]
    calls["ap_cosine_angle"] += [dict(theta=30.0)]
    calls["ap_scanline"] += [dict(tol=1e-3 if kind != "convex_polar" else 2.0)]
    calls["ap_translating_aperture"] += [dict(tol=(1e-3, 2e-3) if kind != "convex_polar"
                                              else (2.0, 3.0))]
    calls["ap_tx_parallelogram"] += [dict(phi=(-2.0, 2.0))]
    for g, kws in calls.items():
        if kind == "convex_cart" and g in ("ap_scanline", "ap_multiline",
                                           "ap_translating_aperture"):
            continue  # the lateral axis of a polar sequence is its angle, not x
        for kw in kws:
            ref = np.asarray(getattr(us, g)(**kw))
            got = getattr(ust, g)(**kw)
            assert isinstance(got, np.ndarray) and got.dtype == np.float32, g
            assert got.shape == ref.shape, (g, got.shape, ref.shape)
            if g in ("ap_multiline", "ap_cosine_angle"):
                assert np.abs(got - ref).max() <= 1e-6, (g, kw)
            else:
                assert np.array_equal(got, ref), (g, kw)


@pytest.mark.parametrize("kind", ["planar_fc", "planar_pw", "convex_polar"])
def test_materialize_matches_reference(kind):
    us, ust = _system(kind)
    for name, p in (("aperture_growth", dict(f=1.2)), ("aperture_growth", dict(Dmax=4e-3)),
                    ("acceptance_angle", dict(theta=25.0)), ("tx_scanline", dict(tol=None)),
                    ("tx_multiline", {}), ("tx_parallelogram", {})):
        ref = np.asarray(JFused(name, **p).materialize(us))
        got = qt.Fused(name, **p).materialize(ust)
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        assert np.abs(got - ref).max() <= 1e-6, (name, p)


def _tiled_problem(T=256, N=16, M=4, I1=8, I2=128):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, N, M)).astype(np.float32)
    Z, X = np.meshgrid(np.linspace(5e-3, 45e-3, I1), np.linspace(-12e-3, 12e-3, I2),
                       indexing="ij")
    pi = np.stack([X.ravel(), np.zeros(X.size), Z.ravel()], -1).astype(np.float32)
    pr = np.stack([np.linspace(-12e-3, 12e-3, N), np.zeros(N), np.zeros(N)],
                  -1).astype(np.float32)
    th = np.radians(np.linspace(-9, 9, M))
    pv = np.zeros((M, 3), np.float32)
    nv = np.stack([np.sin(th), np.zeros(M), np.cos(th)], -1).astype(np.float32)
    t0 = np.full(M, 2 * 5e-3 / 1540.0, np.float32)
    az = np.radians(np.linspace(-6.0, 6.0, N))  # tilted elements: the azimuths count
    ori = np.stack([np.sin(az), np.cos(az)]).astype(np.float32)
    return x, pi, pr, pv, nv, t0, ori, (I1, I2, 1)


LAT_TX = np.linspace(-9e-3, 9e-3, 4)
# (the port's descriptors, the JAX kernel's). The JAX kernel compares its
# cinv-scaled lateral offsets with tol and dlat as given, so it takes them
# scaled; the port's are in the scan's units (ROADMAP Queue 3).
FUSED_CASES = {
    "aperture_growth": ((qt.Fused("aperture_growth", f=1.0),),
                        (JFused("aperture_growth", f=1.0),)),
    "aperture_growth Dmax": ((qt.Fused("aperture_growth", f=0.5, Dmax=12e-3),),
                             (JFused("aperture_growth", f=0.5, Dmax=12e-3),)),
    "acceptance_angle": ((qt.Fused("acceptance_angle", theta=30.0),),
                         (JFused("acceptance_angle", theta=30.0),)),
    "tx_scanline": ((qt.Fused("tx_scanline", tol=3e-3, lat_tx=LAT_TX),),
                    (JFused("tx_scanline", tol=3e-3 * float(CINV), lat_tx=LAT_TX),)),
    "tx_multiline": ((qt.Fused("tx_multiline", dlat=6e-3, lat_tx=LAT_TX),),
                     (JFused("tx_multiline", dlat=6e-3 * float(CINV), lat_tx=LAT_TX),)),
    "tx_parallelogram": ((qt.Fused("tx_parallelogram", xlo=-6e-3, xhi=8e-3),),
                         (JFused("tx_parallelogram", xlo=-6e-3, xhi=8e-3),)),
    "mixed": ((qt.Fused("acceptance_angle", theta=40.0),
               qt.Fused("tx_parallelogram", xlo=-6e-3, xhi=8e-3)),
              (JFused("acceptance_angle", theta=40.0),
               JFused("tx_parallelogram", xlo=-6e-3, xhi=8e-3))),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_weights_match_das_tiled(case):
    """fused_weights + plain das (K1(d)'s plain version) against the JAX
    kernel in interpret mode, ≤ 1e-4 x max: the float32 standard of the
    kernels' parity tests (the two round their delays differently). The
    JAX kernel stops with a NameError on any lat_tx (das_pallas.py:2557,
    ROADMAP Queue 3), so tx_scanline and tx_multiline hold the weights to
    its in-register definition (_tx_apod_weight) instead: equal."""
    x, pi, pr, pv, nv, t0, ori, im = _tiled_problem()
    ours, theirs = FUSED_CASES[case]
    wr, wt = das_cuda.fused_weights(ours, pi, pr, nv, orientations=ori)
    w = (1.0 if wr is None else wr[:, :, None]) * (1.0 if wt is None else wt[:, None, :])
    assert 0 < float(torch.as_tensor(w).mean()) < 1, "the weights must select something"
    if case in ("tx_scanline", "tx_multiline"):
        import jax.numpy as jnp
        from qups_tpu.ops.das_pallas import _tx_apod_weight

        pvk = np.zeros((8, 4), np.float32)
        pvk[7] = LAT_TX * CINV
        prm = dict(theirs[0].params)
        prm.pop("lat_tx")
        ref = np.stack([np.asarray(_tx_apod_weight(
            case, prm, jnp.asarray(pi[:, 0] * CINV), None, None, pvk, m)) for m in range(4)], 1)
        assert np.abs(wt.numpy() - ref).max() <= 1e-6, case
        return
    ref = np.asarray(das_tiled(x, pi, pr, pv, nv, t0, float(CINV), fs=4e6, tx_model="plane",
                               im_shape=im, apod=theirs, orientations=ori, method="linear",
                               interpret=True))
    got = das_cuda.das_sum(torch.as_tensor(x), pi, pr, pv, nv, t0, CINV, fs=4e6,
                           tx_model="plane", method="linear", apod=ours, im_shape=im,
                           orientations=ori).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max(), case


def test_das_sum_apod_keep_cpu_is_plain():
    """On a CPU tensor K1's wrapper takes keep modes and weights to its plain
    version, with no launch; a second descriptor of a kind multiplies in."""
    x, pi, pr, pv, nv, t0, ori, im = _tiled_problem(I1=4, I2=8)
    xt = torch.as_tensor(x)
    before = das_cuda.KEEP_LAUNCHES, das_cuda.APOD_LAUNCHES, das_cuda.LUT_KEEP_LAUNCHES
    apod = (qt.Fused("aperture_growth", f=1.0), qt.Fused("aperture_growth", f=2.0),
            np.full((1, 8, 1, 16, 1), 0.5, np.float32))
    for kr, kt in ((False, False), (True, False), (False, True), (True, True)):
        kw = dict(fs=4e6, tx_model="plane", method="cubic", apod=apod, keep_rx=kr, keep_tx=kt,
                  im_shape=im, orientations=ori)
        got = das_cuda.das_sum(xt, pi, pr, pv, nv, t0, CINV, **kw)
        wr, _ = das_cuda.fused_weights(apod[:2], pi, pr, nv, orientations=ori)
        ref = qt.ops.das(xt, pi, pr, pv, nv, t0, CINV, fs=4e6, tx_model="plane",
                         method="cubic", keep_rx=kr, keep_tx=kt, im_shape=im,
                         apod=(0.5 * wr.reshape(im + (16, 1)),))
        assert got.shape == (32, 16 if kr else 1, 4 if kt else 1)
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert (das_cuda.KEEP_LAUNCHES, das_cuda.APOD_LAUNCHES,
            das_cuda.LUT_KEEP_LAUNCHES) == before
    with pytest.raises(TypeError, match="dense"):
        das_cuda.das_lut_sum(xt, np.zeros((32, 16)), np.zeros((32, 4)), t0, fs=4e6,
                             apod=apod[:1])


def _fsa():
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=3e6)
    us = q.UltrasoundSystem(
        tx=xdc, rx=xdc, seq=q.Sequence(type="FSA", numpulse=16),
        scan=q.ScanCartesian(x=np.linspace(-4e-3, 4e-3, 32), z=np.linspace(16e-3, 24e-3, 32)))
    chd = us.greens(q.Scatterers(pos=np.array([[0.0], [0.0], [20e-3]]), c0=1540.0))
    return us, chd, from_reference(us), from_reference(chd)


@pytest.fixture(scope="module")
def fsa():
    return _fsa()


APODS = {
    "none": lambda us, m: (),
    "Fused aperture_growth": lambda us, m: (m.Fused("aperture_growth", f=1.5),),
    "Fused both rx kinds": lambda us, m: (m.Fused("aperture_growth", f=1.0),
                                          m.Fused("acceptance_angle", theta=30.0)),
    "dense aperture_growth": lambda us, m: (us.ap_aperture_growth(f=1.5),),
    "dense cosine x growth": lambda us, m: (us.ap_cosine_angle(theta=40.0),
                                            us.ap_aperture_growth(f=1.0)),
}


@pytest.mark.parametrize("apod,keep", [(a, k) for a in sorted(APODS)
                                        for k in ("", "rx", "tx", "both")
                                        if (a, k) != ("none", "")])
def test_das_apod_keep_matches_reference(fsa, apod, keep):
    """UltrasoundSystem.DAS with fused or dense apodization and each keep
    mode against the JAX package's (its XLA path off the TPU: Fused
    materialized). 1e-4 x max for the summed image; 2e-4 for kept terms,
    whose largest value is a single (pixel, rx, tx) term: XLA rounds the
    float32 delays with fused multiply-adds and the port does not, and one
    ulp of delay moves a term by up to ~1e-4 of the largest (measured:
    1.07e-4 keep-both)."""
    us, chd, ust, chdt = fsa
    kw = dict(keep_rx=keep in ("rx", "both"), keep_tx=keep in ("tx", "both"))
    ref = np.asarray(us.DAS(chd, apod=APODS[apod](us, q), **kw))
    got = ust.DAS(chdt, apod=APODS[apod](ust, qt), device="cpu", **kw).numpy()
    assert got.shape == ref.shape
    tol = 1e-4 if keep == "" else 2e-4
    assert np.abs(got - ref).max() < tol * np.abs(ref).max(), (apod, keep)


@pytest.mark.parametrize("keep", ["rx", "tx", "both"])
def test_bfdas_keep_matches_reference(fsa, keep):
    """bfDAS with each keep mode (and a dense receive weight) against the
    JAX package's; a Fused descriptor raises in both."""
    us, chd, ust, chdt = fsa
    kw = dict(keep_rx=keep in ("rx", "both"), keep_tx=keep in ("tx", "both"))
    for apod in ((), (us.ap_acceptance_angle(theta=35.0),)):
        ref = np.asarray(us.bfDAS(chd, apod=apod, **kw))
        got = ust.bfDAS(chdt, apod=tuple(np.asarray(a) for a in apod), device="cpu",
                        **kw).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 2e-4 * np.abs(ref).max(), (keep, len(apod))
    with pytest.raises(TypeError):
        ust.bfDAS(chdt, apod=qt.Fused("aperture_growth"), device="cpu")


def test_plain_kernel_route_takes_fused_weights(fsa):
    """kernel='plain' runs K1(d)'s plain version (fused_weights), what the
    card computes; kernel='auto' on the CPU materializes, as the JAX
    package's XLA path. For the receive kinds on this planar array the two
    agree; tx_scanline takes the descriptor's lat_tx in one and the foci
    in the other."""
    _, _, ust, chdt = fsa
    ap = qt.Fused("aperture_growth", f=1.5)
    a = ust.DAS(chdt, apod=ap, device="cpu")
    b = ust.DAS(chdt, apod=ap, device="cpu", kernel="plain")
    assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())
    wr, _ = das_cuda.fused_weights((ap,), ust._pixels(), ust.rx.positions().T,
                                   ust._tx_geometry()[1])
    assert np.array_equal(wr.numpy().reshape(ust.scan.shape + (16, 1)),
                          ap.materialize(ust))


@pytest.mark.parametrize("kind", ["tx_scanline", "tx_multiline"])
def test_bsize_slices_fused_lat_tx(fsa, kind):
    """The bsize repair: a Fused with a per-transmit lat_tx is rebuilt with
    each block's slice, so DAS(bsize=...) through K1's plain version equals
    the unblocked call; before, every block took transmits 0.. of lat_tx."""
    _, _, ust, chdt = fsa
    lat_tx = ust.tx.positions()[0]  # each FSA transmit's own element
    p = dict(tol=0.6e-3) if kind == "tx_scanline" else dict(dlat=0.9e-3)
    ap = qt.Fused(kind, lat_tx=lat_tx, **p)
    sl = _slice_tx_apod(ap, 4, 9, 16)
    assert np.array_equal(sl.p["lat_tx"], lat_tx[4:9]) and sl.kind == kind
    assert _slice_tx_apod(qt.Fused("aperture_growth"), 4, 9, 16) == qt.Fused("aperture_growth")
    full = ust.DAS(chdt, apod=ap, device="cpu", kernel="plain")
    blocked = ust.DAS(chdt, apod=ap, device="cpu", kernel="plain", bsize=5)
    assert float(full.abs().max()) > 0
    assert float((blocked - full).abs().max()) < 1e-5 * float(full.abs().max())
    # the same blocks, each given lat_tx's first transmits (the fault), differ
    pv, nv, model = ust._tx_geometry()
    faulty = []
    for m0 in range(0, 16, 5):
        m1 = min(m0 + 5, 16)
        sub = chdt.replace(data=chdt.data[:, :, m0:m1],
                           t0=np.broadcast_to(chdt.t0_host, (16,))[m0:m1].reshape(1, 1, -1))
        faulty.append(ust._das_block(sub, pv[m0:m1], nv[m0:m1], model,
                                      np.float32(1 / 1540.0),
                                      (qt.Fused(kind, lat_tx=lat_tx[:m1 - m0], **p),),
                                      fmod=0.0, keep_tx=False, keep_rx=False,
                                      method="cubic", kernel="plain", precision="auto"))
    assert float((sum(faulty) - full).abs().max()) > 1e-2 * float(full.abs().max())


def test_scale_matches_reference(fsa):
    us, _, ust, _ = fsa
    ref, got = us.scale(dist=1e3, time=1e6), ust.scale(dist=1e3, time=1e6)
    assert got.fs == pytest.approx(ref.fs)
    assert np.allclose(got.scan.positions(), ref.scan.positions())
    assert np.allclose(got.rx.positions(), ref.rx.positions())
    assert got.seq.c0 == pytest.approx(ref.seq.c0)
