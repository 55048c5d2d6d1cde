"""Shared pieces of the benchmark's own tests (``python3 -m pytest usbench/tests``).

Tests that need a CUDA card carry the ``cuda`` marker and skip inside the
test where there is none."""
import pytest

from usbench import spec

TINY_CONFIG = {
    "name": "tiny", "c0": 1540.0, "fs": 20e6, "T": 256, "t0": 1e-6,
    "transducer": {"numel": 8, "pitch": 0.3e-3, "fc": 5e6, "bw": [3e6, 7e6]},
    "sequence": {"type": "PW", "angles_deg": [-10.0, 10.0, 3]},
    "scan": {"x": [-2e-3, 2e-3, 12], "z": [5e-3, 8e-3, 10]},
    "sampler": "cubic", "precision": "f32", "reduced": [],
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


def tiny_cell(entry: str = "das_rf", frames: int = 0, limit: float = None,
              cell_name: str = "picmus-rf-ensemble") -> spec.Cell:
    """A cell at a size the CPU holds: the tiny configuration under a
    traffic of ``entry`` and ``frames``, held to ``limit`` (default: the
    limit of the benchmark's cell ``cell_name``), with the benchmark's
    metrics."""
    bench = spec.benchmark()
    if limit is None:
        limit = spec.load_json(spec.HERE / "limits" / f"{cell_name}.json")["image_err"]["limit"]
    trf = {"entry": entry, "frames": frames, "resident": 2, "input": "band_noise",
           "check_pixels": 60, "control": "bf16", "check_requests": 10 ** 6}
    if entry == "sim_das":
        trf.update(input="speckle", scatterers=30, check_requests=2,
                   greens={"impl": "freq", "method": "freq"})
    return spec.Cell("tiny", dict(TINY_CONFIG), trf, {"image_err": {"limit": limit}}, 1,
                     list(bench["end_to_end"]), list(bench["per_layer"]))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
