"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic and each metric; the files beside this module hold the rest:

* ``configs/<config>.json``: the deployment's geometry, sampler, precision;
* ``traffic/<traffic>.json``: the mix the general generator reads
  (``traffic.py``): the input and the entry it names, frames a request,
  inputs resident, requests and pixels checked, the control's precision;
* ``inputs/<input>.py``: a generator of inputs from the seed (``make``);
* ``entries/<entry>.py``: the program's call a request makes
  (``request_fn``), and where the control is not the reference on rounded
  taps, the control (``control``);
* ``reference/<entry>.py``: the plain reference's image of that call
  (``image``);
* ``precisions/<precision>.py``: a control's rounding of the taps
  (``round``);
* ``limits/<cell>.json``: each number the check compares, with its limit;
* ``metrics/<metric>.py``: one reader a metric (``read(run)``).

A later cell, entry, input, control, metric or configuration is a new file
here and a new entry in ``BENCHMARK.json``; no file is edited.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    base: Path = HERE  # where its entries, inputs and precisions are found


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or ``bench``) with its files
    under ``base``."""
    bench = benchmark() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = by_name[name]
    return Cell(
        name=name,
        config=load_json(base / "configs" / f"{w['config']}.json"),
        traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(base / "limits" / f"{name}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        base=base,
    )


_MODULES = {}


def module(kind: str, name: str, base: Path = HERE):
    """The module ``<kind>/<name>.py`` under ``base``, found by name and
    loaded once."""
    path = base / kind / f"{name}.py"
    if path not in _MODULES:
        if not path.is_file():
            have = sorted(p.stem for p in (base / kind).glob("*.py") if p.stem[0] != "_")
            raise KeyError(f"no {kind} {name!r} under {base}; have {have}")
        spec = importlib.util.spec_from_file_location(
            f"usbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(metric: str, base: Path = HERE):
    """The ``read(run)`` function of ``metrics/<metric>.py`` under ``base``."""
    return module("metrics", metric, base).read
