"""A cell of ``BENCHMARK.json`` resolved to its files: the configuration
(``slambench/configs/<config>.json``), the traffic mix
(``slambench/traffic/<mix>.json``) and the readers of its per-layer
metrics (``slambench/metrics/<metric>.py``). Everything that belongs to
one configuration, mix or metric lives in its own file; this module only
finds them by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

import numpy as np

from slambench import scene

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BENCHMARK = ROOT / "BENCHMARK.json"


class Metric(NamedTuple):
    name: str
    unit: str
    better: str
    layer: str
    moves: str
    reader: ModuleType


class Traffic(NamedTuple):
    """A traffic mix generated for one camera: the camera centres and yaws
    of every frame the run may use, with what the served loop does."""

    name: str
    ts: np.ndarray              # (N, 3) camera centres
    yaws: np.ndarray            # (N,)
    bg_slope: float
    warmup_frames: int
    profile_start: int          # first window frame of the profiler window
    profile_frames: int         # TRACKING frames the profiler window holds


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    camera: scene.Camera
    traffic: Traffic
    per_layer: tuple            # Metric, the cell's own
    end_to_end: tuple           # (name, unit) reported with --trace 0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def camera_of(config: dict) -> scene.Camera:
    c = config["camera"]
    return scene.Camera(int(c["width"]), int(c["height"]), float(c["fx"]),
                        float(c["fy"]), float(c["cx"]), float(c["cy"]))


def generate(spec: dict) -> tuple[np.ndarray, np.ndarray]:
    """Camera centres and yaws of a mix's frames from its parameters: one
    general generator for every mix file."""
    n = int(spec["frames"])
    path = spec["path"]
    if path["kind"] == "line":
        ts = scene.line_path(n, path["step"], path["y_amp"], path["y_freq"])
    elif path["kind"] == "ellipse":
        ts = scene.ellipse_path(n, path["a"], path["b"], path["lap_frames"],
                                path["y_amp"])
    else:
        raise ValueError(f"unknown path kind {path['kind']!r}")
    yaw = spec.get("yaw", {"amp": 0.0, "freq": 0.0})
    return ts, scene.yaw_path(n, yaw["amp"], yaw["freq"])


def traffic_of(spec: dict) -> Traffic:
    ts, yaws = generate(spec)
    serve = spec["serve"]
    return Traffic(
        name=spec["name"], ts=ts, yaws=yaws,
        bg_slope=float(spec.get("bg_slope", 0.0)),
        warmup_frames=int(serve["warmup_frames"]),
        profile_start=int(serve["profile_start"]),
        profile_frames=int(serve["profile_frames"]),
    )


def load_reader(name: str) -> ModuleType:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(workload: str, bench: dict | None = None) -> Cell:
    """The cell named ``workload`` with its files loaded; raises
    ``KeyError`` for a name ``BENCHMARK.json`` does not have and
    ``ValueError`` where a metric's reader disagrees with its entry."""
    bench = load_json(BENCHMARK) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = traffic_of(load_json(BENCH_DIR / "traffic"
                                   / f"{w['traffic']}.json"))
    metrics = []
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        reader = load_reader(m["name"])
        for key in ("layer", "unit", "moves"):
            if getattr(reader, key.upper()) != m[key]:
                raise ValueError(f"metrics/{m['name']}.py says {key} "
                                 f"{getattr(reader, key.upper())!r}, "
                                 f"BENCHMARK.json {m[key]!r}")
        metrics.append(Metric(m["name"], m["unit"], m["better"], m["layer"],
                              m["moves"], reader))
    e2e = tuple((m["name"], m["unit"]) for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload]))
    return Cell(workload, int(w["chips"]), config, camera_of(config), traffic,
                tuple(metrics), e2e)
