"""The port's cheat sheet (``qups_tpu_torch/examples/cheat_sheet.py``, the
port of ``examples/cheat_sheet.py``) end to end on the CPU, as
``tests/test_torch_display.py::test_demo_main`` runs the demo: every block
runs (its own asserts hold), and its images and sharded results are held to
the JAX package's calls on the same system and the same traces.

Tolerances, max|port - JAX| against max|JAX|: 1e-4, the float32 standard
(the demo's); bfAdjoint 2e-3 (the demo's: JAX's direct phases against the
port's ``2 pi frac(f tau)`` phasors); slsc 1e-3 (unit-normalised samples at
the rounding floor, ``tests/test_torch_coherence.py``); the simulated
traces 2e-4 (``tests/test_torch_system.py``: XLA's fused multiply-adds in
the delays); ``coherence_image(mesh=)`` against JAX's mesh path 5e-3 (its
own test's limit); the in-mesh cohfac 1e-4 where the image is above the
rounding floor (see the test). bfMigration runs JAX op by op
(``jax.disable_jit``), as ``tests/test_torch_refocus.py`` explains.
``fdtd_sharded`` on its one-device mesh equals the port's stepper on the
same batch of transmits, bit for bit (the JAX package's stepper indexes
kappa by column, ``tests/test_torch_fdtd.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import qups_tpu as q  # noqa: E402
from qups_tpu.ops.das import das as jdas  # noqa: E402
from qups_tpu.parallel import mesh as jmesh  # noqa: E402
from qups_tpu_torch.sim import fdtd  # noqa: E402

C0 = 1540.0
TOL = {"bfAdjoint": 2e-3, "slsc": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: the suite runs six workers
    on the machine's cores, and the many small operations of these calls
    (shard by shard, step by step) spin every thread a worker has, which
    slowed the other workers' tests several times over (measured in the
    full run: a test of 9.5 s alone took 670 s). Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def jax_system():
    """The cheat sheet's system in the JAX package."""
    xdc = q.TransducerArray(numel=16, pitch=0.3e-3, fc=5e6)
    ang = np.radians([-10.0, 0.0, 10.0])
    seq = q.Sequence(type="PW", focus=np.stack([np.sin(ang), 0 * ang, np.cos(ang)]), c0=C0)
    scan = q.ScanCartesian(x=np.linspace(-3e-3, 3e-3, 64), y=[0.0],
                           z=np.linspace(12e-3, 24e-3, 64))
    return q.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, scan=scan, fs=25e6)


@pytest.fixture(scope="module")
def sheet():
    from qups_tpu_torch.examples import cheat_sheet

    return cheat_sheet.main(device="cpu")


def test_cheat_sheet_images_match_jax(sheet):
    out = sheet
    chd, chd2 = out["chd"], out["chd2"]
    assert chd.data.device.type == "cpu" and chd.M == 3
    us = jax_system()
    jchd = q.ChannelData(data=chd.data.numpy(), fs=chd.fs, t0=chd.t0_host)
    jchd2 = q.ChannelData(data=chd2.data.numpy(), fs=chd2.fs, t0=chd2.t0_host)
    med = q.Medium(c0=C0, rho0=1000.0, pertreg=((lambda P: P[2] > 20e-3, {"c": 1600.0}),))
    cgrd = q.ScanCartesian(x=np.arange(-4e-3, 4e-3, 0.2e-3), y=[0.0],
                           z=np.arange(0.0, 26e-3, 0.2e-3))
    tau_rx, tau_tx = us.das_delay_tables()
    with jax.disable_jit():
        bmig, _ = us.bfMigration(jchd)
    refs = {"DAS": us.DAS(jchd, method="linear"), "bfDAS": us.bfDAS(jchd),
            "bfAdjoint": us.bfAdjoint(jchd, max_bins=24), "bfMigration": bmig,
            "bfDASLUT": us.bfDASLUT(jchd, tau_rx, tau_tx),
            "IQ": us.DAS(jchd2, fmod=us.fc, method="linear"),
            "fused": us.DAS(jchd, apod=(q.Fused("aperture_growth", f=1.5),), method="linear"),
            "coherence": us.coherence_image(jchd, post="cohfac", method="linear"),
            "slsc": us.coherence_image(jchd, post="slsc", lags=3, method="linear"),
            "bfEikonal": us.bfEikonal(jchd, med, cgrd)}
    assert set(refs) == set(out["images"])
    for name, b in out["images"].items():
        assert rel(b, refs[name]) < TOL.get(name, 1e-4), name
    assert rel(out["us"].greens(out["scat"], device="cpu").data,
               us.greens(q.Scatterers(pos=[[0.0], [0.0], [18e-3]], c0=C0)).data) < 2e-4


def test_cheat_sheet_sharded_match_jax(sheet):
    out = sheet
    chd = out["chd"]
    us = jax_system()
    jchd = q.ChannelData(data=chd.data.numpy(), fs=chd.fs, t0=chd.t0_host)
    sh = out["sharded"]
    pv, nv, model = us._tx_geometry()
    t0 = chd.t0_host.reshape(-1)
    x = chd.data.numpy()
    jm = jmesh.make_mesh(jax.devices()[:1], axes=("rx",), shape=(1,))
    args = (x, us._pixels(), us.rx.positions().T, pv, nv, t0, 1 / C0)
    assert rel(sh["das_sharded"], jmesh.das_sharded(jm, *args, fs=float(chd.fs),
                                                    tx_model=model, method="linear")) < 1e-4
    # cohfac is a ratio: where the kept image is nothing but float32
    # roundings (< 1e-6 of its peak; the pixels whose delays miss the short
    # record are 0) it is the ratio of roundings, and JAX's kernel in
    # interpret mode gives up to 0.16 at 16 such pixels where its own XLA
    # path gives 0; held on the 738 pixels above that floor (coherence_image's
    # mesh path too, the same kernel)
    cf = jmesh.das_sharded_pallas(jm, *args, fs=float(chd.fs), tx_model=model,
                                  im_shape=tuple(us.scan.shape), interpret=True,
                                  post="cohfac")
    brx = np.abs(np.asarray(jdas(*args, fs=float(chd.fs), tx_model=model, method="linear",
                                 keep_rx=True)))[:, :, 0]
    live = brx.max(1) > 1e-6 * brx.max()
    assert live.sum() > 700
    assert rel(sh["das_sharded_pallas"][live], np.asarray(cf)[live]) < 1e-4
    jm2 = jmesh.make_mesh(jax.devices()[:1], axes=("rx", "tx"))
    jscat = q.Scatterers(pos=[[0.0], [0.0], [18e-3]], c0=C0)
    assert rel(sh["greens"], us.greens(jscat, mesh=jm2).data) < 2e-4
    cfi = us.coherence_image(jchd, method="linear", mesh=jm2, precision="f32")
    assert sh["coherence_image"].shape == cfi.shape
    assert rel(sh["coherence_image"].reshape(-1)[live], np.asarray(cfi).reshape(-1)[live]) \
        < 5e-3
    xr = np.real(x).astype(np.float32)
    V = xr.shape[2]
    jy, _ = jmesh.refocus_sharded(jm, xr, np.zeros((V, V), np.float32),
                                  np.eye(V, dtype=np.float32), np.zeros(V, np.float32),
                                  fs=float(chd.fs))
    assert rel(sh["refocus_sharded"], jy) < 1e-4
    sig = np.zeros((4, 32, 2), np.float32)
    sig[:, 5, :] = 1.0
    ref = fdtd.kspace_sim_2d(np.full((48, 48), 1500.0, np.float32),
                             np.full((48, 48), 1000.0, np.float32), [12, 12], [16, 32],
                             torch.as_tensor(sig.transpose(1, 0, 2).copy()), steps=32,
                             dt=4e-8, dx=2e-4, c_ref=1500.0, record_rows=(40,), device="cpu")
    assert torch.equal(sh["fdtd_sharded"], ref.transpose(0, 1))  # one shard, one batch
