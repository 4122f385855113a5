"""Finding a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
its files are

    the configuration   the `file` of its `configs` entry
    the traffic mix     benchmark/traffic/<traffic>.json
    its limits          benchmark/limits/<workload>.json
    a per-layer metric  benchmark/metrics/<metric>.py, a reader (see
                        benchmark/metrics/__init__.py)

so a later change adds a cell, a configuration, a mix or a metric by
adding files and entries, never by editing a file that exists.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict         # the configuration's file
    traffic: dict        # the traffic mix's file
    limits: dict         # the correctness limits of this cell
    end_to_end: list     # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files loaded."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(os.path.join(root, conf["file"])),
        traffic=_load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_load_json(os.path.join(HERE, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """The reader module of per-layer metric `name`
    (benchmark/metrics/<name>.py, loaded by path: names hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_config(config: dict):
    """The program's SystemConfig as the configuration file states it."""
    from spslam_tpu_torch.geometry.camera import Intrinsics
    from spslam_tpu_torch.map.store import MapConfig
    from spslam_tpu_torch.mapping.local_mapper import MapperConfig
    from spslam_tpu_torch.mapping.plane_mapper import PlaneMapperConfig
    from spslam_tpu_torch.system import SystemConfig
    from spslam_tpu_torch.tracking.tracker import TrackerConfig

    plane = config.get("plane_cfg")
    return SystemConfig(
        intr=Intrinsics(**config["camera"]),
        tracker=TrackerConfig(**config["tracker"]),
        mapper=MapperConfig(**config.get("mapper", {})),
        map=MapConfig(**config.get("map", {})),
        plane_cfg=PlaneMapperConfig(**plane) if plane is not None else None,
        **config["system"],
    )
