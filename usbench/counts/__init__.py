"""Frozen operation and byte counts of the program's kernel forms, and the
card's published peaks (``peaks.json``): the least work of each function,
whatever implements it, for the roofline metrics."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
