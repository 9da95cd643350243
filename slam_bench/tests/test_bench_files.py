"""The benchmark's files: BENCHMARK.json to its contract, every
configuration, traffic mix, metric and cell found by name from files of
its own, the course, the bound arithmetic, and what may be imported."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from slam_bench import bounds, course, harness

ROOT = harness.ROOT
BENCH = harness.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.load_benchmark()


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["slam_bench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"keyframes_per_s", "keyframe_p95_ms", "setup_s"} <= e2e
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names


def test_every_file_is_found_by_name():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert harness.load_config(c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        assert harness.find_cell(b, w["name"]) is w
        harness.load_config(w["config"])
        harness.load_traffic(w["traffic"])
    for m in b["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert callable(mod.read) and isinstance(mod.SPANS, list)


def test_a_new_cell_needs_new_files_only(tmp_path, monkeypatch):
    """A configuration, traffic mix, per-layer metric and cell added as
    files (and entries) are found with no change to the harness."""
    shutil.copytree(BENCH, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = harness.load_config("ref_batched")
    cfg["name"] = "ref_new"
    (tmp_path / "slam_bench/configs/ref_new.json").write_text(json.dumps(cfg))
    traffic = dict(harness.load_traffic("revisit"), name="longer",
                   warmup_laps=2.0)
    (tmp_path / "slam_bench/traffic/longer.json").write_text(
        json.dumps(traffic))
    (tmp_path / "slam_bench/metrics/new.metric_ms.py").write_text(
        "SPANS = []\n\ndef read(td):\n    return 1.0\n")
    b["configs"].append(dict(b["configs"][0], name="ref_new",
                             file="slam_bench/configs/ref_new.json"))
    b["workloads"].append(dict(name="ref_new.longer", config="ref_new",
                               traffic="longer", chips=1, why="test"))
    b["per_layer"].append(dict(b["per_layer"][0], name="new.metric_ms",
                               workloads=["ref_new.longer"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "BENCH", tmp_path / "slam_bench")
    nb = harness.load_benchmark()
    cell = harness.find_cell(nb, "ref_new.longer")
    assert harness.load_config(cell["config"])["name"] == "ref_new"
    assert harness.load_traffic(cell["traffic"])["warmup_laps"] == 2.0
    per = harness.metrics_of(nb["per_layer"], "ref_new.longer")
    assert "new.metric_ms" in [m["name"] for m in per]
    assert harness.load_metric("new.metric_ms").read(None) == 1.0


def test_course_repeats_for_a_seed_and_differs_between_seeds():
    p = dict(harness.load_traffic("revisit"), course_keyframes=40)
    p_world = dict(p, world_seed=1)
    a, ga, wa = course.make(p, 2**31 + 7)
    b, gb, wb = course.make(p, 2**31 + 7)
    c, _, _ = course.make(p, 12)
    assert wa == wb and len(a) == len(b) == len(c)
    assert all(np.array_equal(x["ranges"], y["ranges"])
               and np.array_equal(x["odom_pose"], y["odom_pose"])
               for x, y in zip(a, b))
    assert np.array_equal(ga, gb)
    assert not all(np.array_equal(x["ranges"], y["ranges"])
                   for x, y in zip(a, c))
    d, _, _ = course.make(p_world, 2**31 + 7)
    assert not all(np.array_equal(x["ranges"], y["ranges"])
                   for x, y in zip(a, d))


def test_course_equals_the_ports_office_sequence():
    from my_lidar_graph_slam_v2_tpu_torch.scripts.bench_e2e import (
        build_sequence,
    )
    seq = build_sequence(60, seed=5)
    scans, gt, _ = course.build_sequence(60, seed=5)
    assert len(seq.scans) == len(scans)
    for x, y in zip(seq.scans, scans):
        assert np.array_equal(x.ranges, y["ranges"])
        assert np.array_equal(x.odom_pose, y["odom_pose"])
        assert np.array_equal(x.angles, y["angles"])
    assert np.array_equal(seq.ground_truth, gt)


def test_bound_arithmetic_reproduces_the_kernel_table():
    # coarse: T 208, B 512, a 325 x 325 window, one origin, 2 x 2 offsets
    ms, by = bounds.sweep_bound(1, 208, 512, 325, 325, 1, 4, 100_000)
    assert (round(ms, 6), by) == (0.000351, "bytes")
    # loop_coarse_batch: N 8, T 208, 498 x 498, one 11 x 11 tile each
    ms, by = bounds.sweep_bound(8, 208, 512, 498, 498, 1, 121, 809_700)
    assert (round(ms, 6), by) == (0.005857, "adds")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = {"jax", "jaxlib", "flax", "my_lidar_graph_slam_v2_tpu"}


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"numpy", "torch", "math", "__future__"}
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= allowed, (path, tops - allowed)


def test_run_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "-m", "slam_bench.run", "--workload",
         "ref_batched.revisit", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copytree(BENCH, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run(
        [sys.executable, "-m", "slam_bench.run", "--workload",
         "ref_batched.revisit", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
