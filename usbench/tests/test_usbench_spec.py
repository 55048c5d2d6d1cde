"""The harness finds configurations, traffic, limits and metrics by name,
and takes a new file without an edit to any that is there."""
import json
import shutil

import numpy as np
import pytest

from usbench import spec
from usbench.reference import geometry

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def test_every_cell_and_metric_resolves():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c.config["name"] == w["config"]
        assert c.chips == 1
        assert "image_err" in c.limits
        assert c.end_to_end and c.per_layer
        # every per-layer metric's end-to-end metric is reported in the cell
        names = {m["name"] for m in c.end_to_end}
        assert all(m["moves"] in names for m in c.per_layer)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_benchmark_file_keeps_its_schema():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= NAME_CHARS and len(n) <= 64
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    for c in bench["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}


SUBS = ("configs", "traffic", "limits", "metrics", "entries", "inputs", "precisions",
        "reference")


def test_a_new_cell_is_new_files_only(tmp_path):
    for sub in SUBS:
        shutil.copytree(spec.HERE / sub, tmp_path / sub)
    bench = spec.benchmark()
    before = {p.name: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    trf = json.loads((tmp_path / "traffic" / "rf-frame.json").read_text())
    trf["resident"] = 2
    (tmp_path / "traffic" / "rf-frame-2.json").write_text(json.dumps(trf))
    (tmp_path / "limits" / "picmus-rf-frame.json").write_text('{"image_err": {"limit": 1}}')
    (tmp_path / "metrics" / "requests_n.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    bench["workloads"].append({"name": "picmus-rf-frame", "config": "picmus-pw75",
                               "traffic": "rf-frame-2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_n", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "system",
                               "moves": "frames_per_s", "workloads": ["picmus-rf-frame"]})
    c = spec.cell("picmus-rf-frame", bench, base=tmp_path)
    assert c.traffic["resident"] == 2 and c.config["name"] == "picmus-pw75"
    assert [m["name"] for m in c.per_layer] == ["requests_n"]
    assert spec.reader("requests_n", base=tmp_path)(type("R", (), {"requests": [1, 2]})) == 2
    after = {p.name: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_a_new_entry_input_and_control_are_new_files_only(tmp_path):
    # a traffic that names an entry, an input generator and a control
    # precision that the benchmark does not have yet: three new files and
    # its reference, found by name; no file that is there changes
    from usbench import check, harness, traffic
    from usbench.tests.conftest import tiny_cell

    for sub in SUBS:
        shutil.copytree(spec.HERE / sub, tmp_path / sub)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    (tmp_path / "inputs" / "ones.py").write_text(
        "import torch\n\n\ndef make(cfg, trf, seed, device):\n"
        "    return [torch.full((cfg['T'], 8, 3), 1.001, device=device)]\n")
    (tmp_path / "entries" / "das_rf_twice.py").write_text(
        "from usbench.entries import das_rf\n\n\n"
        "def request_fn(cfg, trf, us, device):\n"
        "    one = das_rf.request_fn(cfg, trf, us, device)\n"
        "    return lambda x, calls: one(x, calls) + one(x, calls)\n")
    (tmp_path / "reference" / "das_rf_twice.py").write_text(
        "from usbench.reference.das import das_image\n\n\n"
        "def image(cfg, trf, x, idx, device=None, taps=None):\n"
        "    return 2 * das_image(cfg, x, idx, t0=cfg['t0'], taps=taps)\n")
    (tmp_path / "precisions" / "half.py").write_text(
        "import torch\n\n\ndef round(x):\n    return x.half().double()\n")
    cell = tiny_cell("das_rf")
    cell.traffic.update(entry="das_rf_twice", input="ones", control="half")
    cell.base = tmp_path
    out = harness.run_cell(cell, 7, 0.2, False, "cpu", 0.0)[0]
    assert out["correct"], out["checks"]
    x = traffic.make_inputs(cell.config, cell.traffic, 7, "cpu", tmp_path)[0]
    idx = np.arange(5)
    ref = check.reference(cell, x, idx, "cpu")
    assert check.image_err(check.control(cell, x, idx, "cpu"), ref) > 0
    after = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="headline-rf-cubic"):
        spec.cell("no-such-cell")


@pytest.mark.parametrize("name", ["qups-headline-pw256", "picmus-pw75"])
def test_every_term_lies_on_the_trace(name):
    cfg = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    assert geometry.max_delay_samples(cfg) < cfg["T"] - 3


def test_picmus_time_axis_is_whole_vantage_blocks():
    cfg = spec.load_json(spec.HERE / "configs" / "picmus-pw75.json")
    need = geometry.max_delay_samples(cfg) + 3
    assert cfg["T"] % 128 == 0 and cfg["T"] - 128 < need <= cfg["T"]
