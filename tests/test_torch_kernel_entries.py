"""The port's counterparts of the JAX package's kernel-level entry points
against the JAX functions on the CPU: ``das_tiled``, ``das_lut_tiled`` and
``das_lut_plan`` (K1, K2) against the Pallas kernels in interpret mode on
one chunk of receivers and transmits (16 x 4; interpret mode sums only
the last grid step of several, ROADMAP Queue 3) and against the XLA ``das``
on several chunks; ``prep_sharded`` / ``prep_lut_sharded``'s shard widths
and edge padding against JAX's; ``bf_adjoint_tiled`` (K4) against the XLA
adjoint; ``freq_gemm_cuda`` and ``simus_spectrum_cuda`` (K3) against
``freq_gemm_pallas`` / ``simus_spectrum_pallas`` in interpret mode;
``self_c0``; what each refuses; and the public names of the two packages.
The port runs with ``device="cpu"``, its plain versions. Tolerance:
max|port - JAX| < 1e-4 max|JAX| on the float32 paths (the nearest sampler
may take the other sample where a delay lies within rounding of a half
sample: test_torch_das.assert_flips_only)."""
import ast
import inspect
import pathlib
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import qups_tpu as q  # noqa: E402
from qups_tpu.ops.das import das as das_ref  # noqa: E402
from qups_tpu.ops.das import delay_tables as delay_tables_ref  # noqa: E402
from qups_tpu.ops import das_pallas as jdp  # noqa: E402
from qups_tpu.ops.fdbf import bf_adjoint as bf_adjoint_ref  # noqa: E402
from qups_tpu.ops.greens_freq_pallas import (freq_gemm_pallas,  # noqa: E402
                                             simus_spectrum_pallas)
from qups_tpu.system import self_c0 as self_c0_ref  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch import ops  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402
from qups_tpu_torch.ops import das_cuda, fdbf_cuda, greens_freq_cuda  # noqa: E402
from qups_tpu_torch.system import self_c0  # noqa: E402
from test_torch_apod import FUSED_CASES, _tiled_problem  # noqa: E402
from test_torch_das import (CINV, assert_flips_only, frame_traces,  # noqa: E402
                            geometry_delays64, problem, steady)
from test_torch_das_lut import FS, lut_delays64, lut_problem  # noqa: E402

TOL = 1e-4
CPU = dict(device="cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tests: the suite runs six workers
    on the machine's cores, and these small calls would spin every thread a
    worker has. Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, flips=None):
    """``got`` (a tensor) within TOL max|ref| of ``ref`` everywhere, of the
    same shape and dtype; with ``flips`` (exact delays, their scale, T), a
    pixel may differ only where a nearest delay lies on a rounding edge."""
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape,
                                                                got.dtype, ref.dtype)
    off = (np.abs(got - ref) >= TOL * np.abs(ref).max()).reshape(got.shape[0], -1).any(1)
    if flips is None:
        assert not off.any(), np.abs(got - ref).max() / np.abs(ref).max()
    else:
        assert_flips_only(off, *flips)


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("model", ["plane", "diverging", "virtual"])
def test_das_tiled_matches_pallas_interpret(model, method):
    """One chunk of 16 receivers x 4 transmits, 8 x 128 pixels: the TPU
    kernel's own grid, in interpret mode."""
    x, pi, pr, pv, nv, t0 = problem(model, I1=8, I2=128)
    kw = dict(fs=4e6, tx_model=model, method=method, im_shape=(8, 128, 1))
    ref = steady("the JAX kernel", lambda: np.asarray(jdp.das_tiled(
        x, pi, pr, pv, nv, t0, CINV, interpret=True, **kw)))
    got = steady("the port", lambda: ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, **kw,
                                                   **CPU).numpy())
    flips = (*geometry_delays64(pi, pr, pv, nv, t0, CINV, 4e6, model), x.shape[0]) \
        if method == "nearest" else None
    close(torch.as_tensor(got), ref, flips)


@pytest.mark.parametrize("method", ["cubic", "lanczos3"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_das_tiled_several_chunks_match_xla(method, cplx):
    """48 receivers x 12 transmits, several of the TPU kernel's chunks:
    against the XLA das, which sums them all (and whose lanczos3 the port's
    matches to 1e-4, the TPU kernel's to 1e-3: test_torch_precision)."""
    x, pi, pr, pv, nv, t0 = problem("virtual", N=48, M=12, seed=21, cplx=cplx)
    kw = dict(fs=4e6, tx_model="virtual", method=method)
    close(ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, **kw, **CPU),
          das_ref(x, pi, pr, pv, nv, t0, CINV, **kw))


@pytest.mark.parametrize("case", ["real_fmod_F3", "complex_F2x3", "cubic2x", "bf16pair"])
def test_das_tiled_options_match_pallas_interpret(case):
    """Frames, fmod and complex traces (K1(b)), cubic2x and a reduced trace
    precision (K1(e)), against the JAX kernel in interpret mode."""
    x, pi, pr, pv, nv, t0 = problem("plane", I1=8, I2=128)
    kw = dict(fs=4e6, tx_model="plane", method="cubic", im_shape=(8, 128, 1))
    if case == "real_fmod_F3":
        x, kw["fmod"] = frame_traces(x, (3,), False), 1e6
    elif case == "complex_F2x3":
        x = frame_traces(x, (2, 3), True)
    elif case == "cubic2x":
        kw["method"] = "cubic2x"
    else:
        kw["precision"] = "bf16pair"
    ref = np.asarray(jdp.das_tiled(x, pi, pr, pv, nv, t0, CINV, interpret=True, **kw))
    got = ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, **kw, **CPU)
    close(got, ref.reshape(tuple(got.shape)))


@pytest.mark.parametrize("keep", ["keep_rx", "keep_tx", "both"])
def test_das_tiled_keep_modes_match_pallas_interpret(keep):
    x, pi, pr, pv, nv, t0 = problem("diverging", I1=8, I2=128)
    kw = dict(fs=4e6, tx_model="diverging", method="linear", im_shape=(8, 128, 1),
              keep_rx=keep != "keep_tx", keep_tx=keep != "keep_rx")
    ref = np.asarray(jdp.das_tiled(x, pi, pr, pv, nv, t0, CINV, interpret=True, **kw))
    got = ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, **kw, **CPU)
    assert tuple(got.shape) == (1024, 16 if kw["keep_rx"] else 1, 4 if kw["keep_tx"] else 1)
    close(got, ref)


@pytest.mark.parametrize("case", ["aperture_growth Dmax", "acceptance_angle",
                                  "tx_parallelogram", "mixed"])
def test_das_tiled_fused_from_jax_descriptors(case):
    """JAX Fused descriptors through convert.from_reference, unchanged,
    against the JAX kernel with the same descriptors (the lat_tx kinds stop
    the JAX kernel with a NameError, ROADMAP Queue 3; test_torch_apod holds
    their weights to its in-register definition)."""
    x, pi, pr, pv, nv, t0, ori, im = _tiled_problem()
    theirs = FUSED_CASES[case][1]
    ours = tuple(from_reference(a) for a in theirs)
    assert ours == FUSED_CASES[case][0]
    kw = dict(fs=4e6, tx_model="plane", method="linear", im_shape=im, orientations=ori)
    ref = np.asarray(jdp.das_tiled(x, pi, pr, pv, nv, t0, float(CINV), apod=theirs,
                                   interpret=True, **kw))
    close(ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, apod=ours, **kw, **CPU), ref)


def test_das_tiled_dense_apod_and_lat_tx_kinds_match_xla():
    """What the JAX kernel refuses or stops on, against the XLA das on the
    same weights: dense apodization arrays with keep_rx, and a tx_scanline
    descriptor with lat_tx (its weights materialized as the XLA path takes
    them)."""
    x, pi, pr, pv, nv, t0 = problem("plane", N=24, M=6, I1=8, I2=16, seed=24)
    rng = np.random.default_rng(25)
    w = rng.uniform(size=(8, 16, 1, 24, 6)).astype(np.float32)
    kw = dict(fs=4e6, tx_model="plane", method="cubic", im_shape=(8, 16, 1))
    close(ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, apod=w, keep_rx=True, **kw, **CPU),
          das_ref(x, pi, pr, pv, nv, t0, CINV, apod=(w,), keep_rx=True, **kw))
    lat_tx = np.linspace(-6e-3, 6e-3, 6).astype(np.float32)
    fz = qt.Fused("tx_scanline", tol=4e-3, lat_tx=lat_tx)
    dense = (np.abs(pi[:, 0][:, None] - lat_tx[None]) < np.float32(4e-3)).astype(np.float32)
    close(ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, apod=fz, **kw, **CPU),
          das_ref(x, pi, pr, pv, nv, t0, CINV, apod=(dense.reshape(8, 16, 1, 1, 6),), **kw))


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
def test_das_lut_tiled_matches_pallas_interpret(method):
    """The JAX package's own delay tables (JAX arrays) go to the port as
    they are."""
    x, pi, pr, pv, nv, t0 = problem("plane", I1=8, I2=128)
    tau_rx, tau_tx = delay_tables_ref(pi, pr, pv, nv, 1540.0, "plane")
    kw = dict(fs=4e6, method=method, im_shape=(8, 128, 1))
    ref = steady("the JAX kernel", lambda: np.asarray(jdp.das_lut_tiled(
        x, tau_rx, tau_tx, t0, interpret=True, **kw)))
    got = steady("the port", lambda: ops.das_lut_tiled(x, tau_rx, tau_tx, t0, **kw,
                                                       **CPU).numpy())
    flips = (*lut_delays64(np.asarray(tau_rx), np.asarray(tau_tx), t0), x.shape[0]) \
        if method == "nearest" else None
    close(torch.as_tensor(got), ref, flips)


@pytest.mark.parametrize("case", ["real", "complex_F3_fmod", "keep_rx", "i8x4"])
def test_das_lut_plan_reused_matches_jax_plan(case):
    """One plan, two trace sets: each call equals das_lut_tiled on the same
    traces bit for bit, and the JAX plan's result (interpret mode) within
    the tolerance."""
    x, tau_rx, tau_tx, t0 = lut_problem(I1=8, I2=128)
    kw = dict(fs=FS, method="cubic", im_shape=(8, 128, 1))
    T, N, M = x.shape
    Fn, cplx = None, False
    sets = [x, np.flip(x, 0).copy()]
    if case == "complex_F3_fmod":
        sets = [frame_traces(v, (3,), True, seed=s) for s, v in enumerate(sets)]
        Fn, cplx, kw["fmod"] = 3, True, 1e6
    elif case == "keep_rx":
        kw["keep_rx"] = True
    elif case == "i8x4":
        kw["precision"] = "i8x4"
    plan = ops.das_lut_plan(tau_rx, tau_tx, t0, T=T, N=N, M=M, Fn=Fn, cplx=cplx, **kw, **CPU)
    jplan = jdp.das_lut_plan(tau_rx, tau_tx, t0, T=T, N=N, M=M, Fn=Fn, cplx=cplx,
                             interpret=True, **kw)
    for v in sets:
        got = plan(v)
        assert torch.equal(got, ops.das_lut_tiled(v, tau_rx, tau_tx, t0, **kw, **CPU))
        close(got, np.asarray(jplan(v)).reshape(tuple(got.shape)))


def test_das_lut_plan_checks_its_traces():
    x, tau_rx, tau_tx, t0 = lut_problem(I1=4, I2=8)
    T, N, M = x.shape
    plan = ops.das_lut_plan(tau_rx, tau_tx, t0, fs=FS, T=T, N=N, M=M, **CPU)
    with pytest.raises(ValueError, match="plan"):
        plan(x[:-1])
    with pytest.raises(ValueError, match="Fn"):
        plan(x[..., None])
    with pytest.raises(ValueError, match="cplx"):
        plan(x.astype(np.complex64))
    with pytest.raises(ValueError, match="do not match N = 17"):
        ops.das_lut_plan(tau_rx, tau_tx, t0, fs=FS, T=T, N=N + 1, M=M, **CPU)
    with pytest.raises(ValueError, match="precision"):
        ops.das_lut_plan(tau_rx, tau_tx, t0, fs=FS, T=T, N=N, M=M, precision="bf16", **CPU)


# ----------------------------------------------------------- shard prep
@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (3, 2), (4, 3)])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_prep_sharded_widths_and_pads_match_jax(grid, method):
    """The shard widths, and the geometry, orientations, t0 and lat_tx of
    every shard with their edge padding, equal JAX's (its positions scaled
    by cinv, its t0 less 1/fs for the 4-tap samplers); the shards' images
    summed equal das_tiled's."""
    nrx, ntx = grid
    x, pi, pr, pv, nv, t0 = problem("plane", N=20, M=5, I1=8, I2=16)
    az = np.radians(np.linspace(-6.0, 6.0, 20))
    ori = np.stack([np.sin(az), np.cos(az)]).astype(np.float32)
    lat_tx = np.linspace(-6e-3, 6e-3, 5).astype(np.float32)
    fz = (qt.Fused("acceptance_angle", theta=40.0),
          qt.Fused("tx_multiline", dlat=5e-3, lat_tx=lat_tx))
    jfz = (jdp.Fused("acceptance_angle", theta=40.0),
           jdp.Fused("tx_multiline", dlat=5e-3, lat_tx=lat_tx))
    kw = dict(fs=4e6, T=x.shape[0], tx_model="plane", im_shape=(8, 16, 1), nrx=nrx,
              ntx=ntx, method=method, orientations=ori)
    arrays, st = ops.prep_sharded(pi, pr, pv, nv, t0, CINV, apod=fz, **kw, **CPU)
    ja, jst = jdp.prep_sharded(pi, pr, pv, nv, t0, CINV, apod=jfz, **kw)
    Nsh, Msh = st["Nsh"], st["Msh"]
    assert (Nsh, Msh) == (jst["Nsh"], jst["Msh"])
    assert tuple(arrays["pr"].shape) == (nrx, Nsh, 3) and tuple(arrays["ori"].shape) == (
        nrx, 2, Nsh)
    assert all(tuple(arrays[k].shape) == (ntx, Msh, 3) for k in ("pv", "nv"))
    c = np.float32(CINV)
    for r in range(nrx):
        prs = ja["prs"][r]
        np.testing.assert_array_equal(arrays["pr"][r].numpy().T * c, prs[:3, :Nsh])
        np.testing.assert_array_equal(arrays["ori"][r].numpy(), prs[[6, 7], :Nsh])
    shift = np.float32(1.0) / np.float32(4e6) if method == "cubic" else np.float32(0)
    for t in range(ntx):
        pvs = ja["pvs"][t]
        np.testing.assert_array_equal(arrays["pv"][t].numpy().T * c, pvs[:3, :Msh])
        np.testing.assert_array_equal(arrays["nv"][t].numpy().T, pvs[3:6, :Msh])
        np.testing.assert_array_equal(arrays["t0"][t].numpy() - shift, pvs[6, :Msh])
        for r in range(nrx):
            lt = dict(arrays["apod"][r, t][1].params)["lat_tx"]
            np.testing.assert_array_equal(np.asarray(lt, np.float32) * c, pvs[7, :Msh])
    # the traces padded with zeros to (T, nrx Nsh, ntx Msh), each shard's
    # image summed
    xp = np.zeros((x.shape[0], nrx * Nsh, ntx * Msh), np.float32)
    xp[:, :20, :5] = x
    img = sum(das_cuda.das_sum(
        torch.as_tensor(xp[:, r * Nsh:(r + 1) * Nsh, t * Msh:(t + 1) * Msh]), arrays["pi"],
        arrays["pr"][r], arrays["pv"][t], arrays["nv"][t], arrays["t0"][t], st["cinv"],
        fs=4e6, tx_model="plane", method=method, apod=arrays["apod"][r, t],
        orientations=arrays["ori"][r], im_shape=st["im_shape"])
        for r in range(nrx) for t in range(ntx))
    one = ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, fs=4e6, tx_model="plane", method=method,
                        apod=fz, orientations=ori, im_shape=(8, 16, 1), **CPU)
    close(img, one.numpy())


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (3, 2)])
def test_prep_lut_sharded_widths_and_pads_match_jax(grid):
    nrx, ntx = grid
    x, tau_rx, tau_tx, t0 = lut_problem(N=20, M=5, I1=8, I2=16)
    kw = dict(fs=FS, T=x.shape[0], im_shape=(8, 16, 1), nrx=nrx, ntx=ntx, method="cubic")
    arrays, st = ops.prep_lut_sharded(tau_rx, tau_tx, t0, **kw, **CPU)
    ja, jst = jdp.prep_lut_sharded(tau_rx, tau_tx, t0, **kw)
    Nsh, Msh = st["Nsh"], st["Msh"]
    assert (Nsh, Msh) == (jst["Nsh"], jst["Msh"])
    assert tuple(arrays["taur"].shape) == (nrx, 128, Nsh)
    assert tuple(arrays["taut"].shape) == (ntx, 128, Msh)
    for r in range(nrx):  # JAX's (nrx, Nsh, I1p, I2p) tiles, cropped
        np.testing.assert_array_equal(arrays["taur"][r].numpy().T.reshape(Nsh, 8, 16),
                                      ja["taur"][r, :, :8, :16])
    shift = np.float32(1.0) / np.float32(FS)
    for t in range(ntx):
        np.testing.assert_array_equal(arrays["taut"][t].numpy().T.reshape(Msh, 8, 16),
                                      ja["taut"][t, :, :8, :16])
        np.testing.assert_array_equal(arrays["t0"][t].numpy() - shift, ja["tv"][t, 0, :Msh])


def test_sharded_plans_launch_prep_sharded():
    """The mesh's kernel plans take their shards' operands from the prep
    functions: a 2 x 2 CPU mesh equals the prepped shards summed."""
    from qups_tpu_torch import parallel

    x, pi, pr, pv, nv, t0 = problem("plane", N=20, M=5, I1=8, I2=16)
    mesh = parallel.make_mesh([torch.device("cpu")] * 4, axes=("rx", "tx"), shape=(2, 2))
    kw = dict(fs=4e6, tx_model="plane", method="linear", im_shape=(8, 16, 1))
    got = parallel.das_sharded_pallas(mesh, x, pi, pr, pv, nv, t0, CINV, **kw)
    close(got, ops.das_tiled(x, pi, pr, pv, nv, t0, CINV, **kw, **CPU).numpy())
    tau_rx, tau_tx = delay_tables_ref(pi, pr, pv, nv, 1540.0, "plane")
    got = parallel.das_lut_sharded_pallas(mesh, x, tau_rx, tau_tx, t0, fs=4e6,
                                          method="linear", im_shape=(8, 16, 1))
    close(got, ops.das_lut_tiled(x, tau_rx, tau_tx, t0, fs=4e6, method="linear",
                                 im_shape=(8, 16, 1), **CPU).numpy())


# ------------------------------------------------------------------ K4
def _adjoint_problem(seed=7, T=128, N=8, M=6, V=9, I=40):
    """tests/test_fdbf.py:143-170's sizes, from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, V)).astype(np.float32)
    tau_rx = rng.uniform(0, 2e-6, (I, N)).astype(np.float32)
    tau_tx = rng.uniform(0, 2e-6, (I, M)).astype(np.float32)
    del_tx = rng.uniform(0, 3e-7, (M, V)).astype(np.float32)
    apod = rng.standard_normal((M, V)).astype(np.float32)
    t0 = rng.uniform(0, 1e-6, (V,)).astype(np.float32)
    t0o = rng.uniform(0, 1e-7, (V,)).astype(np.float32)
    return x, tau_rx, tau_tx, del_tx, apod, t0, t0o


@pytest.mark.parametrize("bins", ["uniform", "ragged", "padded"])
@pytest.mark.parametrize("mode", ["sum", "rx", "tx"])
def test_bf_adjoint_tiled_matches_xla(mode, bins):
    """float32, within 2e-3 of max|ref| of the JAX package's XLA adjoint;
    ``BI`` is taken and ignored."""
    args = _adjoint_problem()
    sel = {"uniform": np.arange(5, 17), "ragged": np.array([5, 9, 10, 11, 17]),
           "padded": np.array([5, 6, 7, -1, -1])}[bins].astype(np.int32)
    kw = dict(fs=40e6, fmod=1e6, keep_rx=mode == "rx", keep_tx=mode == "tx")
    ref = np.asarray(bf_adjoint_ref(*args, sel, **kw))
    got = fdbf_cuda.bf_adjoint_tiled(*args, sel, precision="f32", BI=16, **kw, **CPU)
    assert got.shape == ref.shape and got.dtype == torch.complex64
    assert np.abs(got.numpy() - ref).max() < 2e-3 * np.abs(ref).max()
    b16 = fdbf_cuda.bf_adjoint_tiled(*args, sel, **kw, **CPU)  # the default, bf16
    assert np.abs(b16.numpy() - ref).max() < 2e-2 * np.abs(ref).max()


def test_bf_adjoint_tiled_empty_and_refusals():
    args = _adjoint_problem(seed=5, T=64, N=4, M=4, V=4, I=24)
    got = fdbf_cuda.bf_adjoint_tiled(*args, np.zeros(0, np.int32), fs=40e6, **CPU)
    assert tuple(got.shape) == (24,) and not got.any()
    with pytest.raises(ValueError, match="exclusive"):
        fdbf_cuda.bf_adjoint_tiled(*args, np.arange(3), fs=40e6, keep_rx=True, keep_tx=True,
                                   **CPU)
    with pytest.raises(ValueError, match="interpret"):
        fdbf_cuda.bf_adjoint_tiled(*args, np.arange(3), fs=40e6, interpret=True, **CPU)
    with pytest.raises(ValueError, match="precision"):
        fdbf_cuda.bf_adjoint_tiled(*args, np.arange(3), fs=40e6, precision="f16", **CPU)


# ------------------------------------------------------------------ K3
def _gemm_problem(S=13, N=6, M=3, seed=3):
    rng = np.random.default_rng(seed)
    ps = np.stack([rng.uniform(-3e-3, 3e-3, S), np.zeros(S),
                   rng.uniform(8e-3, 12e-3, S)], -1).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, S).astype(np.float32)
    pn = np.stack([np.linspace(-5e-3, 5e-3, N), np.zeros(N), np.zeros(N)], -1)
    pv = np.stack([np.linspace(-3e-3, 3e-3, M), np.zeros(M), np.zeros(M)], -1)
    L = 256
    phc = np.float32(2 * np.pi * (1 / 1540.0) * 15e6 / L)
    return phc, ps, amp, pn[:, None].astype(np.float32), pv[:, None].astype(np.float32), L


@pytest.mark.parametrize("case", ["highest", "attenuated", "bf16", "R0_0"])
def test_freq_gemm_cuda_matches_pallas_interpret(case):
    """float32 within TOL; bf16 within 5e-3 (test_torch_greens_freq's bound:
    a torch.sin and an XLA sin an ulp apart can round to neighbouring bf16
    values)."""
    phc, ps, amp, pn, pv, L = _gemm_problem()
    kw = dict(L=L, k0=9, F=40, R0=0.0 if case == "R0_0" else 1e-3, fsr=2.0,
              precision="bf16" if case == "bf16" else "highest",
              att=0.05 if case == "attenuated" else 0.0)
    G = np.asarray(freq_gemm_pallas(jnp.asarray(phc), ps, amp, pn, pv, interpret=True, **kw))
    got = greens_freq_cuda.freq_gemm_cuda(phc, ps, amp, pn, pv, B=4, SC=128, **kw, **CPU)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (40, 6, 3)
    ref = G[..., 0] + 1j * G[..., 1]
    tol = 5e-3 if case == "bf16" else TOL
    assert np.abs(got.numpy() - ref).max() < tol * np.abs(ref).max()
    flat = greens_freq_cuda.freq_gemm_cuda(phc, ps, amp, pn[:, 0], pv[:, 0], **kw, **CPU)
    assert torch.equal(flat, got)  # (E, 3) geometry: one sub-element


@pytest.mark.parametrize("case", ["soft", "hard", "bf16", "attenuated"])
def test_simus_spectrum_cuda_matches_pallas_interpret(case):
    from test_torch_simus import problem as simus_problem

    (ps, amp, pn, az, pv, azv, widths, _, _), kw = simus_problem()
    kw = dict(k0=12, F=28, baffle="hard" if case == "hard" else "soft",
              precision="bf16" if case == "bf16" else "highest",
              att=0.02 if case == "attenuated" else 0.0, **kw)
    ref = np.asarray(simus_spectrum_pallas(ps, amp, pn, az, pv, azv, widths, SC=128,
                                           interpret=True, **kw))
    got = greens_freq_cuda.simus_spectrum_cuda(ps, amp, pn, az, pv, azv, widths, **kw, **CPU)
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    tol = 5e-3 if case == "bf16" else TOL  # as test_freq_gemm_cuda_matches_pallas_interpret
    assert np.abs(got.numpy() - ref).max() < tol * np.abs(ref).max()


def test_freq_gemm_cuda_refuses_unknown_precision():
    phc, ps, amp, pn, pv, L = _gemm_problem()
    with pytest.raises(ValueError, match="precision"):
        greens_freq_cuda.freq_gemm_cuda(phc, ps, amp, pn, pv, L=L, k0=0, F=4, R0=0.0,
                                        fsr=1.0, precision="f16", **CPU)


# ------------------------------------------------------------ the rest
def test_das_tiled_docstring_example_runs():
    """das_tiled's ``Example:`` block, the JAX function's example on the
    port with its tolerance."""
    code = textwrap.dedent(inspect.getdoc(ops.das_tiled).split("Example:", 1)[1])
    exec(compile(code, "das_tiled", "exec"), {})


def test_self_c0():
    ref = q.UltrasoundSystem(seq=q.Sequence(type="FSA", numpulse=4, c0=1480.0))
    us = from_reference(ref)
    assert self_c0(us) == self_c0_ref(ref) == 1480.0
    assert isinstance(self_c0(us), float)


# each entry point with the smallest arguments that reach its device choice
ENTRIES = {
    "das_tiled": lambda d: ops.das_tiled(np.zeros((8, 2, 1), np.float32), np.zeros((1, 3)),
                                         np.zeros((2, 3)), np.zeros((1, 3)), [[0, 0, 1.0]],
                                         0.0, CINV, fs=1e6, **d),
    "das_lut_tiled": lambda d: ops.das_lut_tiled(np.zeros((8, 2, 1), np.float32),
                                                 np.zeros((1, 2)), np.zeros((1, 1)), 0.0,
                                                 fs=1e6, **d),
    "das_lut_plan": lambda d: ops.das_lut_plan(np.zeros((1, 2)), np.zeros((1, 1)), 0.0,
                                               fs=1e6, T=8, N=2, M=1, **d),
    "prep_sharded": lambda d: ops.prep_sharded(np.zeros((1, 3)), np.zeros((2, 3)),
                                               np.zeros((1, 3)), [[0, 0, 1.0]], 0.0, CINV,
                                               fs=1e6, T=8, tx_model="plane",
                                               im_shape=(1, 1, 1), **d),
    "prep_lut_sharded": lambda d: ops.prep_lut_sharded(np.zeros((1, 2)), np.zeros((1, 1)),
                                                       0.0, fs=1e6, T=8, im_shape=(1, 1, 1),
                                                       **d),
    "bf_adjoint_tiled": lambda d: ops.bf_adjoint_tiled(*_adjoint_problem(seed=1, T=16, N=2,
                                                                         M=2, V=2, I=3),
                                                       np.arange(2, 4), fs=1e6, **d),
    "freq_gemm_cuda": lambda d: ops.freq_gemm_cuda(np.float32(0.1), np.ones((2, 3)),
                                                   np.ones(2), np.zeros((2, 3)),
                                                   np.zeros((1, 3)), L=16, k0=1, F=2,
                                                   R0=0.0, fsr=1.0, **d),
    "simus_spectrum_cuda": lambda d: ops.simus_spectrum_cuda(
        np.ones((2, 3)), np.ones(2), np.zeros((2, 3)), np.zeros(2), np.zeros((1, 3)),
        np.zeros(1), np.full(2, 1e-4), k0=1, F=2, T=16, fs=1e6, c0=1540.0, **d),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_points_default_to_the_card(name):
    """With no device= each entry point wants the CUDA device and raises
    without one, naming device='cpu'; with it, it runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is not refused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRIES[name]({})
    ENTRIES[name](dict(device="cpu"))


@pytest.mark.parametrize("kw, match", [(dict(out="ri"), "Not to port"),
                                       (dict(interpret=True), "Not to port"),
                                       (dict(out="polar"), "unknown out")],
                         ids=["ri", "interpret", "unknown_out"])
@pytest.mark.parametrize("name", ["das_tiled", "das_lut_tiled", "das_lut_plan"])
def test_tpu_contracts_refused(name, kw, match):
    with pytest.raises(ValueError, match=match):
        ENTRIES[name](dict(kw, device="cpu"))


@pytest.mark.parametrize("name", ["das_tiled", "das_lut_tiled"])
def test_uint16_wire_format_refused(name):
    x = np.zeros((8, 2, 1), np.uint16)
    args = ((np.zeros((1, 3)), np.zeros((2, 3)), np.zeros((1, 3)), [[0, 0, 1.0]], 0.0, CINV)
            if name == "das_tiled" else (np.zeros((1, 2)), np.zeros((1, 1)), 0.0))
    with pytest.raises(ValueError, match="wire format"):
        getattr(ops, name)(x, *args, fs=1e6, device="cpu")


def _public_names(pkg: str) -> dict:
    """The public top-level function and class names of a package's modules,
    by name: {name: module path}."""
    out = {}
    for p in sorted((ROOT / pkg).rglob("*.py")):
        if "_build" in p.parts:  # build outputs, not the package
            continue
        for node in ast.parse(p.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                out.setdefault(node.name, str(p.relative_to(ROOT)))
    return out


# The JAX package's public names with no counterpart in the port, and why
# (ROADMAP "Not to port"): TPU-only machinery.
NOT_TO_PORT = {
    "plan_allfast", "plan_allfast_cached", "plan_hostwin",  # the window planners
    "block_gemm_scan",  # the XLA orchestration of the freq engine
    "is_tpu_backend",
}
NOT_TO_PORT_MODULES = ("qups_tpu/utils/cpx.py", "qups_tpu/utils/dataclasses.py")


def test_every_public_jax_name_has_a_counterpart():
    """An AST walk over both packages: every public top-level name of
    qups_tpu has one of the same name in qups_tpu_torch (a ``_pallas``
    suffix as ``_cuda``, the port's module naming) or stands in
    NOT_TO_PORT."""
    jax_names, port_names = _public_names("qups_tpu"), _public_names("qups_tpu_torch")
    missing = {n for n, path in jax_names.items()
               if path not in NOT_TO_PORT_MODULES and n not in port_names
               and n.replace("_pallas", "_cuda") not in port_names}
    assert missing == NOT_TO_PORT, sorted(missing ^ NOT_TO_PORT)
