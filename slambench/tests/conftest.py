"""Shared helpers of the benchmark's CPU tests: a small copy of a cell
(320x240, 500 features) that a test run can hold."""

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def small_config(name: str = "tum1-points") -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cam = cfg["slam"]["camera"]
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] = cam[k] / 2
    cam["width"], cam["height"] = 320, 240
    cfg["slam"]["orb"]["n_features"] = 500
    cfg["slam"]["caps"]["local_points"] = 1024
    return cfg


def small_traffic(name: str = "fr1desk", warm: int = 6, head: int = 4) -> dict:
    tr = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    tr["warm_frames"], tr["head_frames"] = warm, head
    return tr
