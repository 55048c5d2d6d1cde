"""The port's tracing and timing helpers (qups_tpu_torch.utils.profiling)
beside qups_tpu.utils.profiling, on the CPU: the two cases of
tests/test_profiling.py, the Chrome trace's annotation, Timer's
accumulation and its sync argument. The card's trace (a kernel under its
annotation) is in tests/test_torch_cuda.py."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import qups_tpu.utils as jutils  # noqa: E402
import qups_tpu_torch.utils as tutils  # noqa: E402
from qups_tpu_torch.utils import Timer, annotate, trace  # noqa: E402


def test_timer_and_annotation():
    tm = Timer()
    with tm("work"):
        x = torch.arange(1024.0)
        with annotate("square"):
            y = (x * x).sum()
    assert tm.times["work"] > 0
    # the same sum as the JAX package's case
    assert np.isclose(float(y), float((jnp.arange(1024.0) ** 2).sum()), rtol=1e-6)


def test_trace_writes_logdir(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        torch.ones(16).sum()
    found = any("trace" in f or f.endswith(".pb") or f.endswith(".json.gz")
                for _, _, fs in os.walk(d) for f in fs)
    assert found


def test_trace_holds_the_annotation(tmp_path):
    """The Chrome trace names the annotated region and the operations that
    ran inside it, within its span."""
    with trace(str(tmp_path)) as prof:
        with annotate("das"):
            torch.arange(4096.0).reshape(64, 64).matmul(torch.ones(64, 8))
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in ev if e.get("name") == "das" and e.get("ph") == "X"]
    assert len(spans) == 1
    t0, t1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    mm = [e for e in ev if e.get("name") in ("aten::matmul", "aten::mm") and e.get("ph") == "X"]
    assert mm and all(t0 <= e["ts"] <= t1 for e in mm)
    assert any(e.key == "das" for e in prof.key_averages())


def test_timer_accumulates_and_syncs_host_tensors():
    """A name timed twice adds up; a host tensor (or a list of them, or a
    non-tensor) as ``sync`` needs no device and is accepted."""
    tm = Timer()
    for sync in (None, torch.ones(3), [torch.ones(2), 1.0]):
        with tm("a", sync=sync):
            pass
    with tm("b"):
        torch.ones(8).sum()
    assert set(tm.times) == {"a", "b"} and tm.times["a"] > 0
    first = tm.times["a"]
    with tm("a"):
        pass
    assert tm.times["a"] > first


def test_exported_like_the_jax_package():
    """trace, Timer and annotate are exported from utils, as the JAX
    package exports them."""
    for name in ("trace", "Timer", "annotate"):
        assert name in jutils.__all__ and name in tutils.__all__
        assert getattr(tutils, name) is getattr(tutils.profiling, name)


def _spans(prof):
    """{name: [the names of its enclosing host records, innermost first]} of
    the port's spans (``qups.*``) in a profile, one entry a name (the
    first range of that name)."""
    out = {}
    for e in prof.events():
        if e.name.startswith("qups.") and e.name not in out:
            chain, p = [], e.cpu_parent
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            out[e.name] = chain
    return out


def test_annotate_off_is_one_shared_no_op():
    """With no profiler recording, annotate hands out one shared no-op
    context manager, whatever the name, and it records nothing even once a
    profiler records."""
    from qups_tpu_torch.utils import profiling

    off = annotate("qups.a")
    assert off is annotate("qups.b") is profiling._OFF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with off:
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "aten::sum" in names and not any(n.startswith("qups.") for n in names)


def test_annotate_records_a_range_under_its_name():
    """Inside a profiler, annotate records a user range under its name,
    around the work done inside it, nested as the calls nest."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("qups.outer"):
            with annotate("qups.inner"):
                torch.ones(4).sum()
    ev = {e.name: e for e in prof.events()}
    assert ev["qups.outer"].is_user_annotation and ev["qups.inner"].is_user_annotation
    assert ev["qups.inner"].cpu_parent.name == "qups.outer"
    assert ev["aten::sum"].cpu_parent.name == "qups.inner"


def _system(seq):
    import qups_tpu_torch as qt

    xdc = qt.TransducerArray(numel=4, pitch=0.3e-3, fc=3e6)
    return qt.UltrasoundSystem(tx=xdc, rx=xdc, seq=seq, fs=12e6,
                               scan=qt.ScanCartesian(x=np.linspace(-2e-3, 2e-3, 8),
                                                     z=np.linspace(18e-3, 22e-3, 8)))


def test_das_holds_its_geometry_span():
    """A traced DAS on the CPU holds qups.das with qups.das.geometry inside
    it, once for the transmit geometry and once for the pixels."""
    import qups_tpu_torch as qt

    us = _system(qt.Sequence(type="FSA", numpulse=4))
    chd = qt.ChannelData(data=torch.randn(64, 4, 4), fs=12e6, t0=0.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        img = us.DAS(chd, device="cpu")
    assert img.shape[:3] == us.scan.shape
    sp = _spans(prof)
    assert sp["qups.das"] == [] and sp["qups.das.geometry"][0] == "qups.das"
    assert sum(e.name == "qups.das.geometry" for e in prof.events()) == 2


@pytest.mark.parametrize("impl", ["splat", "freq"])
def test_greens_holds_its_phases(impl):
    """A traced greens on the CPU holds qups.greens, with its host set-up
    qups.greens.problem and the transmit synthesis qups.focus_tx (its plan
    qups.focus_tx.plan inside) in it; the frequency engine adds its plan,
    prologue and synthesis spans, inside qups.greens too."""
    import qups_tpu_torch as qt

    us = _system(qt.SequenceRadial(type="PW", angles=[-5.0, 0.0, 5.0], c0=1540.0))
    scat = qt.Scatterers(pos=[[0.0], [0.0], [20e-3]], c0=1540.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        chd = us.greens(scat, impl=impl, device="cpu")
    assert chd.data.shape[2] == 3
    sp = _spans(prof)
    assert sp["qups.greens"] == []
    assert sp["qups.greens.problem"][0] == "qups.greens"
    assert sp["qups.focus_tx"][0] == "qups.greens"
    assert sp["qups.focus_tx.plan"][:2] == ["qups.focus_tx", "qups.greens"]
    freq = {"qups.greens_freq.plan", "qups.greens_freq.prologue", "qups.greens_freq.synth"}
    if impl == "freq":
        assert all("qups.greens" in sp[n] for n in freq)
    else:
        assert not freq & set(sp)


def test_dsp_chain_stays_under_the_callers_range():
    """hilbert().downmix() opens no span of its own, so every op of the
    chain stays under a range its caller opens around it (on the card the
    profiler gives each kernel to the innermost range)."""
    import qups_tpu_torch as qt

    chd = qt.ChannelData(data=torch.randn(64, 4, 3), fs=20e6, t0=1e-6)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("chain"):
            iq = chd.hilbert().downmix(5e6)
    assert iq.data.is_complex()
    ops = [e for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is not None
           and e.cpu_parent.name == "chain"]
    assert {"aten::fft_fft", "aten::fft_ifft"} <= {e.name for e in ops}
    assert not any(e.name.startswith("qups.") for e in prof.events())
