"""The port's loop-closing runtime against the JAX suite's checks of it:
the suffix propagation and the compact-finished-maps equivalence of
``tests/test_e2e_loop.py`` (``:59``, ``:77``), the out-of-extent hit
counter of ``tests/test_rasterize.py:175``, and the map cache's LRU
bound and the serial detector's use of it (``tests/test_map_cache.py``).

The e2e checks run the port alone, with compaction on and off, at the
JAX test's world and sizes; the counter and the cache run both packages
on the same inputs and must count the same.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.graph import pose_graph as jpose_graph
from my_lidar_graph_slam_v2_tpu.grid.builder import (
    GridMapBuilder as JGridMapBuilder,
)
from my_lidar_graph_slam_v2_tpu.grid.builder import (
    GridMapBuilderConfig as JBuilderConfig,
)
from my_lidar_graph_slam_v2_tpu.grid.map_cache import DeviceMapCache as JCache
from my_lidar_graph_slam_v2_tpu.loop.detector import (
    LoopDetectorConfig as JLoopDetectorConfig,
)
from my_lidar_graph_slam_v2_tpu.loop.detector import (
    LoopDetectorCorrelative as JLoopDetectorCorrelative,
)
from my_lidar_graph_slam_v2_tpu.matching.correlative import (
    CorrelativeConfig as JCorrelativeConfig,
)
from my_lidar_graph_slam_v2_tpu.matching.correlative import (
    ScanMatcherCorrelative as JScanMatcherCorrelative,
)
from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
    LinearSolverConfig as JLinearSolverConfig,
)
from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
    ScanMatcherLinearSolver as JScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu.metrics.registry import (
    MetricManager as JMetricManager,
)
from my_lidar_graph_slam_v2_tpu.sensor.data import ScanData as JScanData
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.core import pose as P
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.graph import pose_graph
from my_lidar_graph_slam_v2_tpu_torch.grid.builder import (
    GridMapBuilder,
    GridMapBuilderConfig,
)
from my_lidar_graph_slam_v2_tpu_torch.grid.map_cache import DeviceMapCache
from my_lidar_graph_slam_v2_tpu_torch.loop.detector import (
    LoopDetectorConfig,
    LoopDetectorCorrelative,
)
from my_lidar_graph_slam_v2_tpu_torch.matching.correlative import (
    CorrelativeConfig,
    ScanMatcherCorrelative,
)
from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
    LinearSolverConfig,
    ScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu_torch.pipeline import factory
from my_lidar_graph_slam_v2_tpu_torch.sensor.data import ScanData
from tests.test_map_cache import RES, make_local_map, synth_world_scan
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---- compaction on and off (tests/test_e2e_loop.py:77) ---------------------
@pytest.fixture(scope="module")
def compact_runs():
    """The JAX test's world (a 9 m office, 1.1 laps at 0.2 m) through the
    port's default system with finished maps compacted and kept f32."""
    seq = synthetic.generate(
        synthetic.World.office(seed=3, size=9.0),
        synthetic.loop_trajectory(size=9.0, laps=1.1, step=0.2),
        n_beams=121, max_range=10.0, range_noise=0.01,
        odom_noise=(0.03, 0.012), seed=3)

    def run(compact):
        backend = factory.create_default_backend(
            device="cpu", beam_capacity=256, usable_range_max=10.0,
            n_theta_max=64, crop=384,
            searcher_overrides=dict(travel_dist_threshold=5.0))
        slam = factory.create_default_slam(
            device="cpu", map_rows=512, map_cols=512, beam_capacity=256,
            samples_per_beam=320, usable_range_max=10.0, n_theta_max=64,
            crop=320, backend=backend,
            builder_overrides=dict(compact_finished_maps=compact))
        slam.start_backend()
        for scan in seq.scans:
            slam.process_scan(scan, scan.odom_pose)
        slam.stop_backend()
        pose, gmap = slam.get_global_map()
        return slam, pose, gmap.prob.numpy()

    return run(True), run(False)


def test_compact_finished_maps_equivalence(compact_runs):
    """Finished maps drop their f32 build raster for the u8 matching form;
    loop edges, poses and the global map equal a run that keeps it."""
    (slam_c, pose_c, gmap_c), (slam_n, pose_n, gmap_n) = compact_runs
    finished = [lm for lm in slam_c.builder.local_maps if lm.finished]
    assert finished, "run produced no finished local maps"
    for lm in finished:
        assert lm.compacted and lm.logodds is None and lm.holds_raster
        r = lm.raster(slam_c.builder.cfg.resolution)
        assert r.prob.dtype == torch.uint8 and r.prob is lm.prob_q
    assert all(not lm.compacted for lm in slam_n.builder.local_maps)

    def loops(slam):
        return [(e.local_map_node_id, e.scan_node_id)
                for e in slam.pose_graph.edges if e.is_loop]

    assert loops(slam_c) == loops(slam_n) and len(loops(slam_c)) >= 1
    np.testing.assert_array_equal(slam_c.get_trajectory(),
                                  slam_n.get_trajectory())
    np.testing.assert_allclose(pose_c, pose_n, atol=1e-9)
    np.testing.assert_array_equal(gmap_c, gmap_n)
    # The compact form (u8 + bool) is 2.5x smaller than f32 + bool
    h, w = (slam_c.builder.cfg.local_map_rows,
            slam_c.builder.cfg.local_map_cols)
    for lm in finished:
        compact_bytes = (lm.prob_q.numel() * lm.prob_q.element_size()
                         + lm.observed.numel() * lm.observed.element_size())
        assert compact_bytes <= 0.41 * 5 * h * w


# ---- suffix propagation (tests/test_e2e_loop.py:59) ------------------------
def test_suffix_propagation_consistency(compact_runs):
    """After the loop closures, every scan node's global pose agrees with
    its local map's global pose compounded with its map-local pose."""
    slam = compact_runs[0][0]
    pg = slam.pose_graph
    assert any(e.is_loop for e in pg.edges)
    worst = 0.0
    for node in pg.scan_nodes:
        mp = pg.local_map_nodes[node.local_map_id].global_pose
        recon = P.compound(mp, node.local_pose)
        worst = max(worst, float(np.linalg.norm(recon[:2]
                                                - node.global_pose[:2])))
    assert worst < 0.5, worst


# ---- out-of-extent hits (tests/test_rasterize.py:175) ----------------------
OOB_CFG = dict(local_map_rows=128, local_map_cols=128, latest_map_rows=128,
               latest_map_cols=128, beam_capacity=64, samples_per_beam=32,
               usable_range_max=50.0)


def _oob_ranges(case, n=32):
    if case == "all outside":  # 40 m beams vs a 6.4 m raster
        return np.full(n, 40.0)
    return np.random.default_rng(4).uniform(0.5, 8.0, n)


@pytest.mark.parametrize("case", ["all outside", "some outside"])
def test_out_of_extent_hits_counted(case):
    """Hits beyond the raster are dropped and counted in
    ``GridMapBuilder.OutOfExtentHits`` (fetched at ``flush_oob``): the
    port's counter rises by as many as the JAX package's."""
    n = 32
    ranges = _oob_ranges(case, n)
    angles = np.linspace(-np.pi / 2, np.pi / 2, n)
    args = ("lidar", 0.0, np.zeros(3), np.zeros(3), np.zeros(3), 0.0, 50.0,
            -np.pi / 2, np.pi / 2, angles, ranges)
    jb = JGridMapBuilder(JBuilderConfig(**OOB_CFG))
    pb = GridMapBuilder(GridMapBuilderConfig(**OOB_CFG), "cpu")
    j0, p0 = jb._m_oob_hits.value, pb._m_oob_hits.value
    jb.append_scan(jpose_graph.PoseGraph(), np.zeros(3), np.eye(3) * 1e-6,
                   JScanData(*args))
    pb.append_scan(pose_graph.PoseGraph(), np.zeros(3), np.eye(3) * 1e-6,
                   ScanData(*args))
    assert pb._m_oob_hits.value == p0  # counted on the device until flushed
    jb.flush_oob()
    pb.flush_oob()
    dropped = pb._m_oob_hits.value - p0
    assert dropped == jb._m_oob_hits.value - j0
    if case == "all outside":
        assert dropped == n
    else:
        assert 0 < dropped < n, dropped
    pb.flush_oob()  # nothing pending: no change
    assert pb._m_oob_hits.value - p0 == dropped


# ---- the map cache (tests/test_map_cache.py:56, :102) ----------------------
def _port_map(lm):
    return reference.local_map(
        lm.local_map_id, lm.offset_xy, "cpu",
        logodds=np.asarray(lm.logodds), observed=np.asarray(lm.observed))


def test_lru_eviction_bounded():
    """Three maps through a two-entry cache: one eviction, the evicted map
    is a miss again, the resident one a hit; the JAX cache's stats at
    every step."""
    jc = JCache(RES, max_entries=2, metrics=JMetricManager())
    pc = DeviceMapCache(RES, max_entries=2, metrics=MetricManager())
    jmaps = [make_local_map(i)[0] for i in range(3)]
    pmaps = [_port_map(lm) for lm in jmaps]
    for k in (0, 1, 2):
        jc.raster(jmaps[k]), pc.raster(pmaps[k])
        assert pc.stats == jc.stats
    assert pc.stats["entries"] == 2 and pc.stats["evictions"] == 1
    jc.raster(jmaps[0]), pc.raster(pmaps[0])
    assert pc.stats == jc.stats and pc.stats["misses"] == 4
    jc.raster(jmaps[2]), pc.raster(pmaps[2])
    assert pc.stats == jc.stats and pc.stats["hits"] == 1
    assert len(pc._entries) == 2


def _detector(pkg):
    """The JAX test's serial correlative detector in either package."""
    if pkg == "jax":
        return JLoopDetectorCorrelative(
            JLoopDetectorConfig(score_threshold=0.2, known_rate_threshold=0.1,
                                beam_capacity=192, usable_range_max=12.0),
            JScanMatcherCorrelative(JCorrelativeConfig(
                range_x=1.0, range_y=1.0, range_theta=0.4, n_theta_max=32,
                crop_rows=256, crop_cols=256)),
            JScanMatcherLinearSolver(JLinearSolverConfig()),
            map_cache=JCache(RES, metrics=JMetricManager()),
        )
    ccfg = CorrelativeConfig(range_x=1.0, range_y=1.0, range_theta=0.4,
                             n_theta_max=32, crop_rows=256, crop_cols=256)
    return LoopDetectorCorrelative(
        LoopDetectorConfig(score_threshold=0.2, known_rate_threshold=0.1,
                           beam_capacity=192, usable_range_max=12.0),
        ScanMatcherCorrelative(ccfg, "cpu"),
        ScanMatcherLinearSolver(LinearSolverConfig(), "cpu"),
        map_cache=DeviceMapCache(RES, metrics=MetricManager()),
    )


def test_serial_detector_uses_cache():
    """Repeated ``detect`` on one finished map: one miss, then hits; a
    version bump (the builder's raster write) is a miss again."""
    jlm, _ = make_local_map()
    rng = np.random.default_rng(7)
    true_pose = np.array([0.3, -0.2, 0.15])
    ranges, angles = synth_world_scan(true_pose, rng=rng)
    args = ("S", 0.0, true_pose, np.zeros(3), np.zeros(3), 0.0, 12.0,
            float(angles[0]), float(angles[-1]), angles, ranges)
    runs = {}
    for pkg, lm, ScanT, PG in (("jax", jlm, JScanData, jpose_graph),
                               ("port", _port_map(jlm), ScanData, pose_graph)):
        q = [dict(query_node=PG.ScanNode(0, 0, np.zeros(3), true_pose + 0.05,
                                         ScanT(*args)),
                  local_map=lm,
                  local_map_node=PG.LocalMapNode(0, np.zeros(3),
                                                 finished=True))]
        det = _detector(pkg)
        r1, r2 = det.detect(q), det.detect(q)
        stats = dict(det.map_cache.stats)
        lm.version += 1
        det.detect(q)
        runs[pkg] = (r1, r2, stats, dict(det.map_cache.stats))
    (jr1, jr2, jstats, jbumped), (r1, r2, stats, bumped) = (runs["jax"],
                                                            runs["port"])
    assert len(r1) == len(r2) == len(jr1) == len(jr2) == 1
    assert stats == jstats == dict(entries=1, hits=1, misses=1, evictions=0)
    assert bumped == jbumped and bumped["misses"] == 2
    np.testing.assert_allclose(r1[0]["relative_pose"], r2[0]["relative_pose"],
                               atol=0)
    np.testing.assert_allclose(r1[0]["relative_pose"], jr1[0]["relative_pose"],
                               atol=0.01)


def test_port_scan_data_is_field_for_field_the_reference():
    """The two tests above build both packages' scans from one argument
    tuple, which holds while the dataclasses agree field for field."""
    assert [f.name for f in dataclasses.fields(ScanData)] == \
        [f.name for f in dataclasses.fields(JScanData)]
