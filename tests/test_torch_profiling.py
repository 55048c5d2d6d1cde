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
