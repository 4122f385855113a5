"""BENCHMARK.json against the contract's shape, discovery of each cell's
files by name, and the import rule (no JAX, no JAX package)."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()


def test_benchmark_json_has_the_contracts_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["benchmark"] and B["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = B["end_to_end"] + B["per_layer"]
    for entry in B["configs"] + B["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in B["end_to_end"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in B["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["source"]) <= 200


@pytest.mark.parametrize("name", [w["name"] for w in B["workloads"]])
def test_cells_find_their_files_by_name(name):
    cell = spec.cell(name)
    assert cell.config["name"] == next(w["config"] for w in B["workloads"] if w["name"] == name)
    assert {"room", "trajectory", "frames_per_session", "room_seeds"} <= set(cell.traffic)
    assert {"check_steps", "min_steps", "feature_mismatch"} <= set(cell.limits)
    assert {"pose_gap_mm", "pose_gap_median_mm"} & set(cell.limits)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    cfg = spec.system_config(cell.config)
    assert cfg.intr.fx == cell.config["camera"]["fx"]
    assert cfg.tracker.th_depth == cell.config["tracker"]["th_depth"]
    assert cfg.use_planes == cell.config["system"]["use_planes"]
    reduced = next(c["reduced"] for c in B["configs"] if c["name"] == cell.config["name"])
    assert all(k in cell.config for k in reduced)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["spslam_tpu_torch", "spslam_tpu_torch.system", "numpy",
                                  "jaxtyping", "flax_like"]) == []
    assert run.forbidden_modules(["spslam_tpu.ops.fast", "jaxlib.xla_client", "jax",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib", "spslam_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_file_imports_jax_and_the_reference_imports_no_program():
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                mods = set(_imports(path))
                assert not mods & set(run.FORBIDDEN), path
                if os.sep + "reference" + os.sep in path:
                    assert "spslam_tpu_torch" not in mods and "benchmark" not in mods, path


def test_a_run_loads_no_jax():
    code = ("import sys, benchmark.run, benchmark.harness, benchmark.check, benchmark.readings, "
            "spslam_tpu_torch.system, spslam_tpu_torch.tracking.tracker; "
            "print(benchmark.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')) == []


def test_without_a_card_the_command_prints_nothing_and_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "orbslam2_tum3.orbit", "--seed", str(2**31 + 3), "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
