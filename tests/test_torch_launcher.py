"""The port's CLI path against the JAX package: the Carmen reader and
writer, the settings loader, the map saver, the launcher on a synthetic
Carmen log, and the checkpoint.

Tolerances, fixed before the first run:
- Carmen records, settings-built configurations and saved pose graphs:
  equal (host NumPy code, copied with its logic unchanged);
- the launcher: the same keyframes and loop edges, poses within
  ``E2E_TOL_XY`` / ``E2E_TOL_THETA`` of ``tests/test_torch_backend.py``
  (last-ulp trig and sigmoid, ROADMAP 1.1), the same artefact names, and
  map PNGs of the same shape in which at most 0.1 % of the pixels differ
  (a sigmoid ulp moves a grey level by one) and at most 0.01 % by more
  than one level: poses that differ in the sixth decimal can put the end
  of a ray on the next cell, which moves that cell's counts, not an ulp;
- the checkpoint: a run saved mid-way, loaded into a fresh system and
  finished equals the uninterrupted run bit for bit (the saved poses,
  scans and rasters round-trip exactly, and the rest is recomputed from
  them).
"""
import dataclasses
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.config import settings as jsettings
from my_lidar_graph_slam_v2_tpu.graph import pose_graph as jpg
from my_lidar_graph_slam_v2_tpu.io import carmen as jcarmen
from my_lidar_graph_slam_v2_tpu.io import map_saver as jmap_saver
from my_lidar_graph_slam_v2_tpu.pipeline import launcher as jlauncher
from my_lidar_graph_slam_v2_tpu_torch.config import settings as psettings
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic as psyn
from my_lidar_graph_slam_v2_tpu_torch.graph import pose_graph as ppg
from my_lidar_graph_slam_v2_tpu_torch.io import carmen, map_saver
from my_lidar_graph_slam_v2_tpu_torch.loop.detector import LoopDetectorCorrelative
from my_lidar_graph_slam_v2_tpu_torch.pipeline import checkpoint, factory, launcher
from my_lidar_graph_slam_v2_tpu_torch.sensor.data import OdometryData, ScanData

from tests.test_io_config import write_synthetic_carmen
from tests.test_torch_backend import E2E_TOL_THETA, E2E_TOL_XY
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PNG_OFF_FRACTION = 1e-3
PNG_CELL_FRACTION = 1e-4

# Explicit windows for both matchers and every group a value other than
# its default, so the settings test sees each parser branch.
SETTINGS = {
    "GridMapBuilder": {
        "UsableRangeMax": 6.0, "ProbabilityHit": 0.63,
        "Map": {"NumOfScansForLatestMap": 8,
                "TravelDistThresholdForLocalMap": 2.4},
    },
    "Frontend": {"UpdateThresholdTravelDist": 0.45,
                 "LoopDetectionThreshold": 2.5},
    "ScanOutlierFilter": {"ValidRangeMax": 6.0},
    "ScanInterpolator": {"DistScans": 0.05},
    "ScanMatcherRealTimeCorrelative": {
        "SearchRangeX": 0.25, "SearchRangeY": 0.25, "SearchRangeTheta": 0.5},
    "LoopSearcherNearest": {"TravelDistThreshold": 6.0},
    "LoopDetectorRealTimeCorrelative": {
        "ScoreThreshold": 0.55,
        "ScanMatcher": {"SearchRangeX": 2.5, "SearchRangeY": 2.5,
                        "SearchRangeTheta": 0.5},
    },
    "Backend": {"PoseGraphOptimizerType": "LM"},
    "PoseGraphOptimizerLM": {"NumOfIterationsMax": 8,
                             "LossHuber": {"Scale": 0.02}},
}


def _fields(obj):
    """A module's configuration as plain values, for comparing the two
    packages' objects (dataclasses and the loss object alike)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_fields(v) for v in obj]
    if hasattr(obj, "__dict__"):
        return {k: _fields(v) for k, v in vars(obj).items()}
    return obj


def _configs(slam):
    fe, be = slam.frontend, slam.backend
    ld = be.loop_detector
    return dict(
        builder=_fields(slam.builder.cfg), frontend=_fields(fe.cfg),
        correlative=_fields(fe.scan_matcher.ccfg),
        refine=_fields(fe.scan_matcher.lcfg),
        final=_fields(fe.final_scan_matcher.cfg),
        outlier=_fields(fe.outlier_filter),
        interpolator=_fields(fe.interpolator),
        searcher=_fields(be.loop_searcher.cfg), detector=_fields(ld.cfg),
        loop_matcher=_fields(ld.scan_matcher.cfg),
        loop_final=_fields(ld.final_scan_matcher.cfg),
        optimizer=_fields(be.optimizer.cfg),
    )


# ---- Carmen ---------------------------------------------------------------
def _records_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert type(ra).__name__ == type(rb).__name__
        for k, va in vars(ra).items():
            np.testing.assert_array_equal(np.asarray(va),
                                          np.asarray(getattr(rb, k)), k)


def test_carmen_reader_equals_reference(tmp_path):
    """Every record format (FLASER, ODOM, ROBOTLASER1, RAWLASER1, PARAM
    fallbacks, a garbage line) parses to the JAX Python reader's records."""
    p = tmp_path / "t.log"
    write_synthetic_carmen(p, n=6)
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
    got = carmen.read_carmen_log(str(p))
    assert sum(isinstance(r, ScanData) for r in got) == 8
    assert sum(isinstance(r, OdometryData) for r in got) == 6
    _records_equal(got, jcarmen.read_carmen_log(str(p), native=False))


def test_carmen_writer_round_trip(tmp_path):
    """The port's writer and reader round-trip a synthetic sequence (to
    the writer's printed digits), and the JAX reader reads the port's file
    to the same records."""
    seq = psyn.generate(psyn.World.office(seed=2, size=6.0),
                        psyn.loop_trajectory(size=6.0, laps=0.1, step=0.2),
                        n_beams=91, max_range=6.0, seed=3)
    path = tmp_path / "w.log"
    carmen.write_carmen_log(seq.scans, str(path))
    back = carmen.read_carmen_log(str(path), native=None)
    assert len(back) == len(seq.scans)
    for s, r in zip(seq.scans, back):
        np.testing.assert_allclose(r.ranges, s.ranges, atol=1e-6)
        np.testing.assert_allclose(r.angles, s.angles, atol=1e-9)
        np.testing.assert_allclose(r.odom_pose, s.odom_pose, atol=1e-9)
        assert r.time_stamp == pytest.approx(s.time_stamp, abs=1e-6)
    _records_equal(back, jcarmen.read_carmen_log(str(path), native=False))
    native = carmen.read_carmen_log(str(path), native=True)
    assert len(native) == len(back)
    for a, b in zip(native, back):
        np.testing.assert_array_equal(a.ranges, b.ranges)
        np.testing.assert_array_equal(a.odom_pose, b.odom_pose)


# ---- settings -------------------------------------------------------------
def test_settings_build_the_reference_configs(tmp_path):
    path = tmp_path / "s.json"
    path.write_text(json.dumps(SETTINGS))
    kw = dict(map_rows=256, map_cols=256, n_theta_max=64, crop=256,
              inline_backend=True)
    j = jsettings.create_slam_from_settings(jsettings.load_settings(path), **kw)
    p = psettings.create_slam_from_settings(psettings.load_settings(path),
                                            device="cpu", **kw)
    assert _configs(p) == _configs(j)
    # the JAX loader's detector choice: serial and unfused
    assert isinstance(p.backend.loop_detector, LoopDetectorCorrelative)
    assert p.builder.device == torch.device("cpu")


def test_settings_default_loop_window_is_the_factory_window():
    """With no settings at all the loop matcher searches 2.5 m x 2.5 m x
    0.5 rad, as ``create_default_backend`` does (ROADMAP 3.1: the JAX
    loader falls back to the frontend's 0.25 m there)."""
    slam = psettings.create_slam_from_settings(
        {}, map_rows=256, map_cols=256, n_theta_max=64, crop=256,
        device="cpu")
    lm = slam.backend.loop_detector.scan_matcher.cfg
    ref = factory.create_default_backend(device="cpu").loop_detector.mcfg
    assert (lm.range_x, lm.range_y, lm.range_theta) == \
        (ref.range_x, ref.range_y, ref.range_theta) == (2.5, 2.5, 0.5)
    assert slam.frontend.scan_matcher.ccfg.range_x == 0.25
    assert slam.backend.loop_detector.cfg.score_threshold == 0.55


@pytest.mark.parametrize("name", ["GridSearch", "HillClimbing"])
def test_settings_refuse_matchers_not_ported(name):
    """Both matchers build from an empty group with the JAX loader's
    defaults (nothing is refused any more)."""
    kw = dict(resolution=0.05, n_theta_max=64, crop=256)
    got = psettings.create_scan_matcher_from_group({}, name, "G",
                                                   device="cpu", **kw)
    want = jsettings.create_scan_matcher_from_group({}, name, "G", **kw)
    assert _fields(got.cfg) == _fields(want.cfg)
    assert got.device == torch.device("cpu")


# ---- map saver ------------------------------------------------------------
def _graph(module):
    pg = module.PoseGraph()
    pg.local_map_nodes.append(module.LocalMapNode(0, np.array([1.0, 2.0, 0.3]),
                                                  True))
    for i in range(3):
        pg.scan_nodes.append(module.ScanNode(
            i, 0, np.array([0.1 * i, 0.0, 0.01]),
            np.array([1.1 + 0.1 * i, 2.1, 0.31]), None))
        pg.edges.append(module.PoseGraphEdge(
            0, i, 0, module.CONSTRAINT_LOOP if i == 2 else 0,
            np.array([0.1, 0.1 * i, 0.01]), np.eye(3) * (5 + i)))
    return pg


def test_map_saver_round_trip(tmp_path):
    """The pose graph round-trips, its JSON is the JAX saver's byte for
    byte, and a device raster saves to the JAX saver's PNG and metadata."""
    pg = _graph(ppg)
    map_saver.save_pose_graph(pg, str(tmp_path / "p.posegraph.json"))
    jmap_saver.save_pose_graph(_graph(jpg), str(tmp_path / "j.posegraph.json"))
    assert (tmp_path / "p.posegraph.json").read_bytes() == \
        (tmp_path / "j.posegraph.json").read_bytes()
    back = map_saver.load_pose_graph(str(tmp_path / "p.posegraph.json"))
    for a, b in zip(back.scan_nodes, pg.scan_nodes):
        np.testing.assert_array_equal(a.global_pose, b.global_pose)
        np.testing.assert_array_equal(a.local_pose, b.local_pose)
    for a, b in zip(back.edges, pg.edges):
        assert (a.local_map_node_id, a.scan_node_id, a.edge_type,
                a.constraint_type) == (b.local_map_node_id, b.scan_node_id,
                                       b.edge_type, b.constraint_type)
        np.testing.assert_array_equal(a.information_mat, b.information_mat)
    assert [e.is_loop for e in back.edges] == [False, False, True]

    from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster as JRaster
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import MapRaster

    rng = np.random.default_rng(3)
    prob = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    obs = rng.uniform(size=prob.shape) < 0.7
    off = np.array([-1.4, -1.0])
    pose = np.array([0.5, -0.2, 0.3])
    traj = pose + rng.normal(0, 0.3, (6, 3))
    raster = MapRaster(torch.from_numpy(prob), torch.from_numpy(obs), 0.05, off)
    map_saver.save_map(raster, str(tmp_path / "pm"), pose, trajectory=traj)
    jmap_saver.save_map(JRaster(prob, obs, 0.05, off), str(tmp_path / "jm"),
                        pose, trajectory=traj)
    for ext in (".png", ".json"):
        assert (tmp_path / f"pm{ext}").read_bytes() == \
            (tmp_path / f"jm{ext}").read_bytes()
    map_saver.save_precomputed_maps(raster, str(tmp_path / "pc"), pose,
                                    heights=(1, 2))
    jmap_saver.save_precomputed_maps(JRaster(prob, obs, 0.05, off),
                                     str(tmp_path / "jc"), pose,
                                     heights=(1, 2))
    for name in ("precomp-2.png", "precomp-4.png", "precomp.json"):
        assert (tmp_path / f"pc.{name}").read_bytes() == \
            (tmp_path / f"jc.{name}").read_bytes()


# ---- the launcher ---------------------------------------------------------
def _read_png(path) -> np.ndarray:
    """The grey image of an 8-bit PNG as the savers write it (filter 0)."""
    data = Path(path).read_bytes()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not raw[:, 0].any()
    return raw[:, 1:]


def _log_world(path):
    """A 6 m office, 1.15 laps at 0.2 m steps: 77 scans, 27 keyframes and
    two loop edges in both packages."""
    seq = psyn.generate(psyn.World.office(seed=1, size=6.0),
                        psyn.loop_trajectory(size=6.0, laps=1.15, step=0.2),
                        n_beams=121, max_range=6.0, range_noise=0.01,
                        odom_noise=(0.05, 0.02), seed=7)
    carmen.write_carmen_log(seq.scans, str(path))
    return seq


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both launchers on one Carmen log with the same explicit settings;
    the port on ``--device cpu``."""
    tmp = tmp_path_factory.mktemp("cli")
    seq = _log_world(tmp / "w.log")
    (tmp / "s.json").write_text(json.dumps(SETTINGS))
    common = [str(tmp / "w.log"), str(tmp / "s.json")]
    opts = ["--map-size", "512", "--draw-every", "10"]
    for d in ("jax", "port"):
        (tmp / d).mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SLAM_TPU_CACHE_DIR", "")  # no XLA cache outside tmp
        assert jlauncher.main(common + [str(tmp / "jax" / "run")] + opts) == 0
    assert launcher.main(common + [str(tmp / "port" / "run")] + opts
                         + ["--device", "cpu"]) == 0
    return tmp, seq


def _saved_graph(d):
    g = json.loads((d / "run.posegraph.json").read_text())
    poses = np.array([n["GlobalPose"] for n in g["ScanNodes"]])
    loops = [(e["LocalMapNodeId"], e["ScanNodeId"]) for e in g["Edges"]
             if e["ConstraintType"] == "Loop"]
    return poses, loops


def test_launcher_matches_reference(cli_runs):
    tmp, seq = cli_runs
    (jp, jl), (pp, pl) = _saved_graph(tmp / "jax"), _saved_graph(tmp / "port")
    assert len(pp) == len(jp) >= 20
    assert pl == jl and len(pl) >= 1
    d = np.abs(pp - jp)
    assert d[:, :2].max() <= E2E_TOL_XY, d[:, :2].max()
    assert d[:, 2].max() <= E2E_TOL_THETA, d[:, 2].max()


def test_launcher_writes_the_reference_artefacts(cli_runs):
    tmp, _ = cli_runs
    names = {d: sorted(p.name for p in (tmp / d).iterdir())
             for d in ("jax", "port")}
    assert names["port"] == names["jax"]
    assert {"run.png", "run.json", "run.posegraph.json", "run.latest.png",
            "run.latest.json", "run.metric.json", "run.graph.svg"} <= \
        set(names["port"])
    metrics = json.loads((tmp / "port" / "run.metric.json").read_text())
    assert int(metrics["ValueSequences"]["Frontend.ProcessTime"]
               ["NumOfSamples"]) >= 20
    for name in ("run.png", "run.latest.png"):
        a, b = _read_png(tmp / "port" / name), _read_png(tmp / "jax" / name)
        assert a.shape == b.shape
        diff = np.abs(a.astype(int) - b.astype(int))
        assert np.count_nonzero(diff) <= PNG_OFF_FRACTION * diff.size, name
        assert np.count_nonzero(diff > 1) <= PNG_CELL_FRACTION * diff.size, \
            name
    for name in ("run.json", "run.latest.json"):
        a, b = (json.loads((tmp / d / name).read_text())
                for d in ("port", "jax"))
        for k in ("Rows", "Cols", "Resolution"):
            assert a["Map"][k] == b["Map"][k], k
        np.testing.assert_allclose(
            [a["Map"]["OffsetX"], a["Map"]["OffsetY"]],
            [b["Map"]["OffsetX"], b["Map"]["OffsetY"]], atol=E2E_TOL_XY)
        np.testing.assert_allclose(a["GlobalMapPose"], b["GlobalMapPose"],
                                   atol=E2E_TOL_XY)


def test_launcher_device_defaults_to_cuda(tmp_path, monkeypatch):
    """Without CUDA and without ``--device`` the launcher refuses to run
    (no CPU fallback) and writes nothing."""
    log = tmp_path / "w.log"
    write_synthetic_carmen(log)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launcher.main([str(log), None, str(tmp_path / "out")]) != 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["w.log"]


# ---- checkpoint -----------------------------------------------------------
def _ckpt_slam():
    return factory.create_default_slam(
        device="cpu", map_rows=384, map_cols=384, beam_capacity=256,
        samples_per_beam=192, usable_range_max=8.0, n_theta_max=32,
        crop=256, builder_overrides=dict(travel_dist_threshold=1.0,
                                         num_scans_for_latest_map=4,
                                         num_overlapped_scans=4))


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    """Save mid-run (finished, compacted maps and the open map's f32
    raster), load into a fresh system, finish: the trajectory, the graph
    and every local map equal the uninterrupted run's."""
    seq = psyn.generate(psyn.World.office(seed=4, size=8.0),
                        psyn.loop_trajectory(size=8.0, laps=0.5, step=0.25),
                        n_beams=121, max_range=8.0, seed=5)
    full = _ckpt_slam()
    for s in seq.scans:
        full.process_scan(s, s.odom_pose)

    half = len(seq.scans) // 2
    first = _ckpt_slam()
    for s in seq.scans[:half]:
        first.process_scan(s, s.odom_pose)
    maps = first.builder.local_maps
    assert any(m.compacted for m in maps) and not maps[-1].compacted
    checkpoint.save(first, str(tmp_path / "ckpt"))

    resumed = checkpoint.load(_ckpt_slam(), str(tmp_path / "ckpt"))
    for a, b in zip(resumed.builder.local_maps, maps):
        for k in ("logodds", "prob_q", "observed"):
            va, vb = getattr(a, k), getattr(b, k)
            assert (va is None) == (vb is None), k
            if va is not None:
                assert torch.equal(va, vb), k
    for s in seq.scans[half:]:
        resumed.process_scan(s, s.odom_pose)
    assert np.array_equal(resumed.get_trajectory(), full.get_trajectory())
    assert len(resumed.builder.local_maps) == len(full.builder.local_maps)
    for a, b in zip(resumed.builder.local_maps, full.builder.local_maps):
        assert a.compacted == b.compacted
        assert torch.equal(a.observed, b.observed)
        assert torch.equal(a.prob_q if a.compacted else a.logodds,
                           b.prob_q if b.compacted else b.logodds)


def test_checkpoint_shape_comes_from_the_saved_raster(tmp_path):
    """A restored map takes its shape from the saved array, not from the
    configuration (ROADMAP 3.4); a map with neither raster nor scans (an
    owner-sharded checkpoint) is restored dropped, keeping its extent and
    offset, and the maps whose scans are held are rebuilt."""
    seq = psyn.generate(psyn.World.office(seed=4, size=8.0),
                        psyn.loop_trajectory(size=8.0, laps=0.3, step=0.25),
                        n_beams=121, max_range=8.0, seed=5)
    slam = _ckpt_slam()
    for s in seq.scans:
        slam.process_scan(s, s.odom_pose)
    prefix = str(tmp_path / "ckpt")
    checkpoint.save(slam, prefix)
    small = factory.create_default_slam(
        device="cpu", map_rows=128, map_cols=128, beam_capacity=256,
        samples_per_beam=192, usable_range_max=8.0, n_theta_max=32,
        crop=96)
    restored = checkpoint.load(small, prefix)
    for a, b in zip(restored.builder.local_maps, slam.builder.local_maps):
        assert a.observed.shape == b.observed.shape == (384, 384)
        np.testing.assert_array_equal(a.offset_xy, b.offset_xy)

    np.savez(f"{prefix}.maps.npz")  # no rasters
    pg = json.loads(Path(f"{prefix}.posegraph.json").read_text())
    state = json.loads(Path(f"{prefix}.state.json").read_text())
    state["scan_meta"] = state["scan_meta"][1:]  # scan 0 held elsewhere
    Path(f"{prefix}.state.json").write_text(json.dumps(state))
    assert len(pg["ScanNodes"]) > 1
    restored = checkpoint.load(_ckpt_slam(), prefix)
    m0 = restored.builder.local_maps[0]
    assert m0.dropped and not m0.holds_raster and m0.shape == (384, 384)
    np.testing.assert_array_equal(m0.offset_xy,
                                  slam.builder.local_maps[0].offset_xy)
    with pytest.raises(RuntimeError, match="owner"):
        m0.raster(0.05)
    assert restored.pose_graph.scan_nodes[0].scan_data is None
    assert restored.builder.local_maps[-1].holds_raster
