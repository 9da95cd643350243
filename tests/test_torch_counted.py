"""The port's remaining host and grid modules against the JAX package's:
``GridCounted``, the NumPy copies ``grid/geometry.py`` and
``utils/oracle.py``, the native Carmen parser, and the settings loader's
GridSearch and HillClimbing groups.

Tolerances: GridCounted's planes and views are integers and f32 values
computed by the same IEEE operations, and the copies run the same NumPy
code, so those comparisons are equality.  The native parser is the same
C++ source, but the JAX package builds it with ``-march=native``, which
lets g++ fuse a multiply and an add into one rounding: a derived field
(``max_angle = start + res * (n - 1)``) may differ by an ulp, so the two
native readers agree within rtol 1e-15 (the first run showed one such
ulp) and exactly in everything parsed straight from the text.  Against
the Python reader the native records are equal in every field parsed
from the text and differ in the record tag, as the JAX package's own
two readers do.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.config import settings as jsettings
from my_lidar_graph_slam_v2_tpu.grid import geometry as jgeometry
from my_lidar_graph_slam_v2_tpu.grid.counted import GridCounted as JGridCounted
from my_lidar_graph_slam_v2_tpu.io import carmen as jcarmen
from my_lidar_graph_slam_v2_tpu.utils import oracle as joracle
from my_lidar_graph_slam_v2_tpu_torch import native, reference
from my_lidar_graph_slam_v2_tpu_torch.config import settings as psettings
from my_lidar_graph_slam_v2_tpu_torch.grid import geometry
from my_lidar_graph_slam_v2_tpu_torch.grid.counted import GridCounted
from my_lidar_graph_slam_v2_tpu_torch.io import carmen
from my_lidar_graph_slam_v2_tpu_torch.matching.grid_search import (
    ScanMatcherGridSearch,
)
from my_lidar_graph_slam_v2_tpu_torch.matching.hill_climbing import (
    ScanMatcherHillClimbing,
)
from my_lidar_graph_slam_v2_tpu_torch.pipeline import factory
from my_lidar_graph_slam_v2_tpu_torch.sensor.data import OdometryData, ScanData
from my_lidar_graph_slam_v2_tpu_torch.utils import oracle

from tests.test_io_config import write_synthetic_carmen


# ---- GridCounted ----------------------------------------------------------
def _batches(rng, rows, cols, n_batches, N):
    """Update batches with duplicates (few distinct cells), out-of-raster
    indices on every side, and an optional validity mask."""
    out = []
    for k in range(n_batches):
        rr = rng.integers(-3, rows + 3, N)
        cc = rng.integers(-3, cols + 3, N)
        rr[: N // 4] = rng.integers(0, 3, N // 4)  # piled on a few cells
        cc[: N // 4] = rng.integers(0, 3, N // 4)
        out.append((rr, cc, rng.random(N) > 0.4,
                    None if k % 2 else rng.random(N) > 0.1))
    return out


@pytest.mark.parametrize("rows,cols,n_batches,N",
                         [(16, 16, 2, 400), (40, 24, 5, 1000), (7, 50, 3, 64)])
def test_grid_counted_equals_reference(rows, cols, n_batches, N):
    rng = np.random.default_rng(rows * cols + N)
    j, p = JGridCounted(rows, cols), GridCounted(rows, cols, "cpu")
    for rr, cc, hh, vv in _batches(rng, rows, cols, n_batches, N):
        j.update(rr, cc, hh, vv)
        p.update(rr, cc, hh, vv)
        assert torch.equal(p.counts, torch.as_tensor(np.array(j.counts)))
        assert torch.equal(p.hits, torch.as_tensor(np.array(j.hits)))
    assert torch.equal(p.prob(), torch.as_tensor(np.array(j.prob())))
    assert torch.equal(p.observed, torch.as_tensor(np.array(j.observed)))
    u16 = np.asarray(j.values_u16())
    assert p.values_u16().dtype == torch.uint16
    assert np.array_equal(p.values_u16().to(torch.int32).numpy(), u16)
    assert torch.equal(p.values_u8(), torch.as_tensor(np.array(j.values_u8())))
    assert p.memory_usage() == j.memory_usage()
    # the planes carried over from the JAX object give the same views
    q = reference.grid_counted(np.asarray(j.hits), np.asarray(j.counts), "cpu")
    assert torch.equal(q.values_u8(), p.values_u8())
    p.reset()
    j.reset()
    assert not p.counts.any() and not p.hits.any()
    assert not p.values_u16().to(torch.int32).any()


def test_grid_counted_takes_tensors():
    """Index tensors give the same state as the NumPy arrays."""
    rng = np.random.default_rng(3)
    rr, cc, hh, vv = _batches(rng, 12, 12, 1, 200)[0]
    a, b = GridCounted(12, 12, "cpu"), GridCounted(12, 12, "cpu")
    a.update(rr, cc, hh, vv)
    b.update(*(torch.as_tensor(x) for x in (rr, cc, hh, vv)))
    assert torch.equal(a.hits, b.hits) and torch.equal(a.counts, b.counts)


# ---- the NumPy copies -----------------------------------------------------
def test_geometry_copy_equals_reference():
    rng = np.random.default_rng(5)
    args = (0.05, 40, 60, -1.013, 0.517)
    j, p = jgeometry.GridGeometry(*args), geometry.GridGeometry(*args)
    x, y = rng.uniform(-2, 3, 100), rng.uniform(-1, 3, 100)
    for fn in ("position_to_index", "position_to_index_f"):
        for a, b in zip(getattr(j, fn)(x, y), getattr(p, fn)(x, y)):
            assert np.array_equal(a, b)
    r, c = rng.integers(-5, 70, 100), rng.integers(-5, 70, 100)
    assert np.array_equal(j.is_index_inside(r, c), p.is_index_inside(r, c))
    for a, b in zip(j.index_to_position(r, c), p.index_to_position(r, c)):
        assert np.array_equal(a, b)
    assert dataclasses.asdict(j.scaled(4)) == dataclasses.asdict(p.scaled(4))
    assert (dataclasses.asdict(jgeometry.GridGeometry.centered(0.05, 8, 9, 1, 2))
            == dataclasses.asdict(geometry.GridGeometry.centered(0.05, 8, 9, 1, 2)))
    assert (j.width, j.height) == (p.width, p.height)


def test_oracle_copy_equals_reference():
    rng = np.random.default_rng(6)
    g = geometry.GridGeometry(0.05, 30, 30, -0.75, -0.75)
    jg = jgeometry.GridGeometry(0.05, 30, 30, -0.75, -0.75)
    assert oracle.traverse_pixels(0.2, 0.3, 7.9, 3.1) == \
        joracle.traverse_pixels(0.2, 0.3, 7.9, 3.1)
    assert oracle.missed_cells((0.0, 0.0), (0.6, -0.4), g) == \
        joracle.missed_cells((0.0, 0.0), (0.6, -0.4), jg)
    vals = np.zeros((30, 30), np.uint16)
    hits = rng.uniform(-0.6, 0.6, (12, 2))
    a = oracle.integrate_scan_oracle(vals.copy(), g, (0.0, 0.0), hits, 1.6, 0.85)
    b = joracle.integrate_scan_oracle(vals.copy(), jg, (0.0, 0.0), hits, 1.6,
                                      0.85)
    assert np.array_equal(a, b)
    assert np.array_equal(oracle.precompute_map_oracle(a, 4),
                          joracle.precompute_map_oracle(b, 4))
    prob = rng.uniform(0, 1, (30, 30))
    rows, cols = rng.integers(-2, 32, 50), rng.integers(-2, 32, 50)
    assert oracle.score_pixel_accurate_oracle(prob, rows, cols, 50) == \
        joracle.score_pixel_accurate_oracle(prob, rows, cols, 50)


# ---- the native Carmen parser ---------------------------------------------
def _log(tmp_path):
    p = tmp_path / "t.log"
    write_synthetic_carmen(p, n=10)
    beams = " ".join("5.0" for _ in range(181))
    with p.open("a") as f:
        f.write(
            "\nROBOTLASER1 0 -1.5707963 3.1415927 0.0174533 30.0 0.01 0 "
            f"181 {beams} 0 1.0 2.0 0.1 0.9 1.9 0.1 0.5 0.1 0.3 0.2 0.1 "
            "200.5 host 200.5\n"
            "RAWLASER1 0 -1.5707963 3.1415927 0.0174533 30.0 0.01 0 "
            f"181 {beams} 0 201.5 host 201.5\n"
            "garbage line that should be skipped\n"
        )
    return p


def test_native_reader_equals_the_python_reader_and_reference(tmp_path):
    """The native records equal the JAX package's native records field for
    field, and the Python reader's in every numeric field; the library is
    built under ``build/native/`` by a hash of the source, never next to
    it."""
    p = _log(tmp_path)
    got = carmen.read_carmen_log(str(p), native=True)
    lib = native.library_path("carmen_reader")
    assert lib.exists() and lib.parent.name == "native"
    assert lib.parent.parent.name == "build"
    assert not list(native.SRC_DIR.glob("*.so"))
    ref = jcarmen.read_carmen_log(str(p), native=True)
    py = carmen.read_carmen_log(str(p), native=None)
    assert len(got) == len(ref) == len(py) == 22
    for a, b, c in zip(got, ref, py):
        assert type(a).__name__ == type(b).__name__ == type(c).__name__
        for k, va in vars(a).items():
            vb = getattr(b, k)
            if isinstance(va, str):
                assert va == vb, k
            else:
                np.testing.assert_allclose(va, vb, rtol=1e-15, atol=0,
                                           err_msg=k)
        if isinstance(a, ScanData):
            for k in ("ranges", "angles", "odom_pose", "time_stamp",
                      "max_range"):
                np.testing.assert_array_equal(getattr(a, k), getattr(c, k))
            np.testing.assert_allclose(a.relative_sensor_pose,
                                       c.relative_sensor_pose, atol=1e-12)
        else:
            assert isinstance(a, OdometryData)
            np.testing.assert_array_equal(a.pose, c.pose)
            np.testing.assert_array_equal(a.velocity, c.velocity)


def test_native_reader_raises_without_gxx(tmp_path, monkeypatch):
    """No g++: ``native=True`` raises and says so; nothing falls back to
    the Python reader."""
    p = _log(tmp_path)
    monkeypatch.setattr(native, "_carmen", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build" / "native")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g[+][+]"):
        carmen.read_carmen_log(str(p), native=True)
    assert not (tmp_path / "build").exists()
    assert len(carmen.read_carmen_log(str(p), native=False)) == 22
    monkeypatch.undo()
    with pytest.raises(OSError):  # built, but the log is not there
        carmen.read_carmen_log(str(tmp_path / "missing.log"), native=True)


# ---- settings -------------------------------------------------------------
# The reference file's groups for both matchers (launcher_settings_default
# .json: ScanMatcherHillClimbing with CostGreedyEndpoint, and the GridSearch
# loop detector's matcher at 0.05 / 0.05 / 0.005 with GreedyEndpoint).
REF_GROUPS = {
    "CostGreedyEndpoint": {"HitAndMissedDist": 0.075,
                           "OccupancyThreshold": 0.1, "KernelSize": 1,
                           "StandardDeviation": 0.05, "ScalingFactor": 1.0},
    "CostSquareError": {"CovarianceScale": 10000.0},
    "ScanMatcherHillClimbing": {
        "LinearStep": 0.1, "AngularStep": 0.1, "MaxIterations": 100,
        "MaxNumOfRefinements": 5, "CostType": "GreedyEndpoint",
        "CostConfigGroup": "CostGreedyEndpoint"},
    "LoopDetectorGridSearch": {"ScanMatcher": {
        "SearchRangeX": 2.5, "SearchRangeY": 2.5, "SearchRangeTheta": 0.5,
        "SearchStepX": 0.05, "SearchStepY": 0.05, "SearchStepTheta": 0.005,
        "ScoreType": "PixelAccurate", "CostType": "GreedyEndpoint",
        "CostConfigGroup": "CostGreedyEndpoint"}},
    "Odd": {"LinearStep": 0.2, "MaxIterations": 7, "SearchStepX": 0.025,
            "SearchRangeTheta": 0.3},
}


@pytest.mark.parametrize("type_name,group", [
    ("HillClimbing", "ScanMatcherHillClimbing"),
    ("GridSearch", "LoopDetectorGridSearch/ScanMatcher"),
    ("HillClimbing", "Odd"),
    ("GridSearch", "Odd"),
    ("GridSearch", "Missing"),
])
def test_settings_build_the_reference_matchers(type_name, group):
    kw = dict(resolution=0.05, n_theta_max=64, crop=256)
    j = jsettings.create_scan_matcher_from_group(REF_GROUPS, type_name, group,
                                                 **kw)
    p = psettings.create_scan_matcher_from_group(REF_GROUPS, type_name, group,
                                                 device="cpu", **kw)
    assert isinstance(p, (ScanMatcherGridSearch, ScanMatcherHillClimbing))
    assert dataclasses.asdict(p.cfg) == dataclasses.asdict(j.cfg)
    assert p.device == torch.device("cpu")
    convert = (reference.grid_search_config if type_name == "GridSearch"
               else reference.hill_climbing_config)
    assert convert(dataclasses.asdict(j.cfg)) == p.cfg
    # the factory builds the same type from the same fields
    f = factory.create_scan_matcher(type_name, device="cpu", **vars(p.cfg))
    assert type(f) is type(p) and f.cfg == p.cfg


def test_settings_json_round_trip_builds_the_loop_grid_search(tmp_path):
    """A settings file naming the GridSearch loop group builds a serial
    ``LoopDetectorCorrelative`` around the grid-search matcher in both
    packages, with equal fields."""
    s = dict(REF_GROUPS, Backend={"LoopDetectorConfigGroup":
                                  "LoopDetectorGridSearch"})
    s["LoopDetectorGridSearch"] = dict(s["LoopDetectorGridSearch"],
                                       ScanMatcherType="GridSearch")
    path = tmp_path / "s.json"
    path.write_text(json.dumps(s))
    kw = dict(map_rows=128, map_cols=128, n_theta_max=16, crop=96,
              loop_crop=128, inline_backend=True)
    j = jsettings.create_slam_from_settings(jsettings.load_settings(path), **kw)
    p = psettings.create_slam_from_settings(psettings.load_settings(path),
                                            device="cpu", **kw)
    jm, pm = j.backend.loop_detector.scan_matcher, \
        p.backend.loop_detector.scan_matcher
    assert isinstance(pm, ScanMatcherGridSearch)
    assert dataclasses.asdict(pm.cfg) == dataclasses.asdict(jm.cfg)
    assert pm.cfg.cost.cost_type == "GreedyEndpoint"
    assert pm.cfg.wins == (25, 25, 50)
