"""The port's serialization (qups_tpu_torch.io) against qups_tpu.io, on the
CPU: save_chd/load_chd (real and complex traces, scalar and per-transmit
t0) bit for bit and across the packages both ways; checkpoints (the
unsharded case of tests/test_checkpoint.py, numpy leaves through
torch.load(weights_only=True), templates with ``like``); obj2dict against
the JAX package's dict of the same object and dict2obj back. Also: no
module of qups_tpu_torch imports jax, qups_tpu, h5py or matplotlib.
The checkpoint landing on the card is in tests/test_torch_cuda.py."""
import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import qups_tpu as q  # noqa: E402
from qups_tpu import io as jio  # noqa: E402
import qups_tpu_torch as qt  # noqa: E402
from qups_tpu_torch import io as tio  # noqa: E402
from qups_tpu_torch.convert import from_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _traces(cplx, t0):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((48, 8, 3)).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    return x, t0


T0S = {"scalar": 2.5e-6, "per_tx": np.array([1e-6, 2e-6, 3.5e-6])}


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("t0", list(T0S), ids=list(T0S))
def test_chd_round_trip(tmp_path, cplx, t0):
    x, t = _traces(cplx, T0S[t0])
    chd = qt.ChannelData(data=torch.from_numpy(x), fs=20e6, t0=t)
    p = tmp_path / "c.npz"
    tio.save_chd(str(p), chd)
    back = tio.load_chd(str(p))
    assert back.data.device.type == "cpu" and back.data.dtype == chd.data.dtype
    assert torch.equal(back.data, chd.data)
    assert back.fs == chd.fs
    np.testing.assert_array_equal(back.t0_host, chd.t0_host)
    on = tio.load_chd(str(p), device="cpu")
    assert torch.equal(on.data, chd.data)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("t0", list(T0S), ids=list(T0S))
def test_chd_files_cross_packages(tmp_path, cplx, t0):
    """A .npz written by either package loads in the other, bit for bit."""
    x, t = _traces(cplx, T0S[t0])
    ref = q.ChannelData(data=x, fs=20e6, t0=t)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jio.save_chd(pj, ref)
    got = tio.load_chd(pj)
    np.testing.assert_array_equal(got.data.numpy(), x)
    assert got.fs == 20e6
    np.testing.assert_array_equal(got.t0_host, np.asarray(ref.t0_host, np.float64))
    tio.save_chd(pt, from_reference(ref))
    back = jio.load_chd(pt)
    np.testing.assert_array_equal(np.asarray(back.data), x)
    np.testing.assert_array_equal(np.asarray(back.t0_host), np.asarray(ref.t0_host))


def test_checkpoint_pytree_roundtrip(tmp_path):
    """tests/test_checkpoint.py's unsharded case: numpy leaves come back as
    numpy."""
    tree = {"img": np.arange(12.0).reshape(3, 4),
            "meta": {"fs": np.float32(31.25e6)}}
    p = str(tmp_path / "ckpt")
    tio.save_checkpoint(p, tree)
    back = tio.load_checkpoint(p)
    assert np.allclose(back["img"], tree["img"])
    assert np.isclose(back["meta"]["fs"], tree["meta"]["fs"])
    assert isinstance(back["img"], np.ndarray) and back["img"].dtype == np.float64
    assert isinstance(back["meta"]["fs"], np.float32)


def test_checkpoint_leaves_and_weights_only(tmp_path):
    """Tensors (real and complex), numpy arrays, scalars and strings in
    dicts, lists and tuples; the file loads with weights_only=True, as
    torch.load's default takes it."""
    img = torch.randn(4, 5, dtype=torch.complex64)
    tree = {"img": img, "stack": [torch.arange(6), np.arange(3, dtype=np.int16)],
            "pair": (np.ones((2, 2), np.complex64), 3.5), "name": "pw75", "n": 7}
    p = str(tmp_path / "c.pt")
    tio.save_checkpoint(p, tree)
    torch.load(p, weights_only=True)
    back = tio.load_checkpoint(p)
    assert torch.equal(back["img"], img)
    assert torch.equal(back["stack"][0], torch.arange(6))
    assert back["stack"][1].dtype == np.int16 and isinstance(back["stack"][1], np.ndarray)
    assert isinstance(back["pair"], tuple) and back["pair"][1] == 3.5
    np.testing.assert_array_equal(back["pair"][0], np.ones((2, 2), np.complex64))
    assert back["name"] == "pw75" and back["n"] == 7


def test_checkpoint_like(tmp_path):
    """With a template, each leaf takes the dtype and device of the
    template's leaf; leaves without one come back as stored."""
    tree = {"a": np.arange(6.0), "b": torch.arange(4, dtype=torch.float32), "c": np.ones(2)}
    p = str(tmp_path / "c.pt")
    tio.save_checkpoint(p, tree)
    like = {"a": torch.zeros(6, dtype=torch.float32, device="cpu"),
            "b": np.zeros(4, np.float64)}
    back = tio.load_checkpoint(p, like=like)
    assert isinstance(back["a"], torch.Tensor) and back["a"].dtype == torch.float32
    assert torch.equal(back["a"], torch.arange(6, dtype=torch.float32))
    assert isinstance(back["b"], np.ndarray) and back["b"].dtype == np.float64
    assert isinstance(back["c"], np.ndarray)


OBJS = {
    "L11_5v": lambda m: m.TransducerArray.L11_5v(),
    "C5_2v": lambda m: m.TransducerConvex.C5_2v(),
    "matrix": lambda m: m.TransducerMatrix(pitch2=(0.3e-3, 0.3e-3), numd=(4, 3), fc=3e6),
    "PW": lambda m: m.SequenceRadial(type="PW", angles=np.linspace(-16, 16, 5), c0=1540.0),
    "FSA": lambda m: m.Sequence(type="FSA", numpulse=8),
    "cartesian": lambda m: m.ScanCartesian(x=np.linspace(-5e-3, 5e-3, 7),
                                           z=np.linspace(10e-3, 20e-3, 5)),
    "polar": lambda m: m.ScanPolar(origin=(0, 0, -1e-3), r=np.linspace(0, 30e-3, 6),
                                   a=np.linspace(-30, 30, 4)),
    "scatterers": lambda m: m.Scatterers(pos=np.array([[0.0, 1e-3], [0, 0], [5e-3, 8e-3]]),
                                         amp=np.array([1.0, 0.5]), c0=1500.0),
    "system": lambda m: m.UltrasoundSystem(
        tx=m.TransducerArray.L11_5v(), rx=m.TransducerArray.L11_5v(),
        seq=m.SequenceRadial(type="PW", angles=[-5.0, 0.0, 5.0]),
        scan=m.ScanCartesian(x=np.linspace(-1e-3, 1e-3, 4), z=np.linspace(1e-3, 2e-3, 3))),
}


def _same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, str) or a is None:
        assert a == b, where
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


def _data(d):
    """The dict without its None entries: a dropped function (a waveform's)
    comes back as None from dict2obj, in both packages."""
    if isinstance(d, dict):
        return {k: _data(v) for k, v in d.items() if v is not None}
    return d


@pytest.mark.parametrize("name", list(OBJS))
def test_obj2dict_matches_jax_and_round_trips(name):
    ref = OBJS[name](q)
    got = tio.obj2dict(from_reference(ref))
    _same(jio.obj2dict(ref), got, name)
    back = tio.dict2obj(got)
    assert type(back) is type(OBJS[name](qt))
    _same(_data(tio.obj2dict(back)), _data(got), name)
    _same(_data(tio.obj2dict(back)), _data(jio.obj2dict(jio.dict2obj(jio.obj2dict(ref)))), name)


def test_obj2dict_of_channel_data():
    """A tensor field becomes host numpy (the JAX package keeps its array);
    dict2obj gives the traces back as a tensor."""
    x = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    chd = qt.ChannelData(data=torch.from_numpy(x), fs=1e6, t0=np.array([1.0, 2.0, 3.0]))
    d = tio.obj2dict(chd)
    assert isinstance(d["data"], np.ndarray)
    np.testing.assert_array_equal(d["data"], x)
    _same(jio.obj2dict(q.ChannelData(data=x, fs=1e6, t0=np.array([1.0, 2.0, 3.0]))), d, "chd")
    back = tio.dict2obj(d)
    assert isinstance(back.data, torch.Tensor) and torch.equal(back.data, chd.data)
    np.testing.assert_array_equal(back.t0_host, chd.t0_host)


def test_no_module_imports_jax_or_the_jax_package():
    """No module of qups_tpu_torch imports jax or qups_tpu, in its source or
    when every module is imported; nor h5py or matplotlib when imported
    (they are imported inside the functions that need them)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|qups_tpu)(\.|\s|$)", re.M)
    srcs = sorted(f for f in (ROOT / "qups_tpu_torch").rglob("*.py")
                  if "_build" not in f.relative_to(ROOT).parts)  # build outputs aside
    assert len(srcs) > 30
    for f in srcs:
        assert not pat.search(f.read_text()), f
    mods = [m.name for m in pkgutil.walk_packages(qt.__path__, "qups_tpu_torch.")]
    assert {"qups_tpu_torch.interop", "qups_tpu_torch.io", "qups_tpu_torch.display",
            "qups_tpu_torch.utils.profiling",
            "qups_tpu_torch.examples.demo_imaging"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'qups_tpu', 'h5py', 'matplotlib')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_methods_bound_on_import():
    """``import qups_tpu_torch`` binds imagesc, plot and gif as qups_tpu
    does."""
    for cls, names in ((qt.ChannelData, ("imagesc", "gif")), (qt.Scan, ("imagesc", "plot", "gif")),
                       (qt.Medium, ("imagesc",)), (qt.Transducer, ("plot",)),
                       (qt.Scatterers, ("plot",))):
        for n in names:
            assert hasattr(getattr(q, cls.__name__), n), (cls, n)
            assert getattr(cls, n).__module__ == "qups_tpu_torch.display", (cls, n)
    assert dataclasses.is_dataclass(qt.ChannelData)
