"""Frontend paths of the port that the main-path tests do not reach, held
against the JAX package: degeneration with odometry fusion, the full
latest-map rebuild, and the fused matcher on a materialized raster."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.datasets import synthetic as jsyn
from my_lidar_graph_slam_v2_tpu.matching.types import ScanMatchingQuery
from my_lidar_graph_slam_v2_tpu.metrics.registry import (
    MetricManager as JMetricManager,
)
from my_lidar_graph_slam_v2_tpu.models.fused_matcher import (
    FusedCorrelativeGNMatcher as JFused,
)
from my_lidar_graph_slam_v2_tpu.pipeline.factory import (
    create_default_slam as jax_create_default_slam,
)
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic as psyn
from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
    ScanMatchingQuery as PScanMatchingQuery,
)
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu_torch.models.fused_matcher import (
    FusedCorrelativeGNMatcher as PFused,
)
from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import create_default_slam
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = dict(map_rows=384, map_cols=384, samples_per_beam=256,
             usable_range_max=8.0, n_theta_max=64, crop=256)
# Same algorithm in f32 on both sides; last-ulp trig/sigmoid differences
# move a pose by far less than a millimetre (measured: 1.4e-7 m).
POSE_TOL = 1e-3


def _corridor(module):
    """Two long parallel walls: along the corridor the scan constrains
    nothing, so the match covariance is degenerate."""
    world = module.World(np.array([[-12, -1.2, 12, -1.2], [-12, 1.2, 12, 1.2]],
                                  float))
    x = np.arange(0, 5.0, 0.08)
    traj = np.stack([x, 0.05 * np.sin(x), np.zeros_like(x)], -1)
    return module.generate(world, traj, n_beams=181, max_range=8.0,
                           range_noise=0.01, odom_noise=(0.03, 0.01), seed=5)


def _drive(slam, seq):
    for scan in seq.scans:
        slam.process_scan(scan, scan.odom_pose)
    return slam.get_trajectory()


def test_degeneration_and_odometry_fusion():
    """Drives ``_check_degeneration`` and ``_fuse_odometry`` end to end
    (``fuse_odometry_covariance=True``): both packages flag the same
    keyframes as degenerate and fuse them the same way."""
    name = "Frontend.DegenerationCount"
    jdegen = JMetricManager.instance().counter(name)
    pdegen = MetricManager.instance().counter(name)
    overrides = dict(frontend_overrides=dict(fuse_odometry_covariance=True))
    j0, p0 = jdegen.value, pdegen.value
    j_est = _drive(jax_create_default_slam(**SIZES, **overrides),
                   _corridor(jsyn))
    p_est = _drive(create_default_slam(device="cpu", **SIZES, **overrides),
                   _corridor(psyn))
    j_degen, p_degen = jdegen.value - j0, pdegen.value - p0
    assert j_degen > 0 and p_degen == j_degen
    assert p_est.shape == j_est.shape
    np.testing.assert_allclose(p_est, j_est, atol=POSE_TOL)


@pytest.fixture(scope="module")
def office_runs():
    world_seq = [(m, m.generate(
        m.World.office(seed=2, size=10.0),
        m.loop_trajectory(size=10.0, laps=0.15, step=0.08),
        n_beams=181, max_range=10.0, range_noise=0.01,
        odom_noise=(0.03, 0.01), seed=6)) for m in (jsyn, psyn)]
    jslam = jax_create_default_slam(**SIZES)
    pslam = create_default_slam(device="cpu", **SIZES)
    _drive(jslam, world_seq[0][1])
    _drive(pslam, world_seq[1][1])
    return jslam, pslam


def test_latest_map_full_rebuild(office_runs):
    """``update_latest_map`` with the incremental path off rebuilds the
    latest map from its scans.  Sample cells are ``floor(f32 / res)``, so
    a cell may flip where a sample sits on a cell edge: at most 0.2% of
    cells differ by more than 1e-5 in log-odds, and the observed masks by
    at most 0.2%."""
    jslam, pslam = office_runs
    for slam in (jslam, pslam):
        slam.builder.cfg = dataclasses.replace(
            slam.builder.cfg, latest_map_incremental=False)
        slam.builder.update_latest_map(slam.pose_graph)
    np.testing.assert_array_equal(pslam.builder.latest_map_pose,
                                  jslam.builder.latest_map_pose)
    lo_j = np.asarray(jslam.builder.latest_logodds)
    lo_p = pslam.builder.latest_logodds.numpy()
    assert (~np.isclose(lo_p, lo_j, rtol=0, atol=1e-5)).mean() <= 2e-3
    obs_j = np.asarray(jslam.builder.latest_observed)
    assert (pslam.builder.latest_observed.numpy() != obs_j).mean() <= 2e-3
    assert obs_j.sum() > 1000


def test_fused_matcher_on_latest_raster(office_runs):
    """The fused matcher's raster path (``optimize_pose``, used when the
    fold inputs do not apply) on the same u8 latest raster: pose to 1e-4
    (f32 reductions in another order)."""
    jslam, pslam = office_runs
    jm = jslam.frontend.scan_matcher
    _, jraster, _ = jslam.get_latest_data()
    prob, obs = np.asarray(jraster.prob), np.asarray(jraster.observed)
    praster = reference.map_raster(prob, obs, jraster.offset_xy,
                                   jraster.resolution, "cpu")
    node = jslam.pose_graph.scan_nodes[-1]
    scan = jslam.frontend._scan_arrays(node.scan_data)
    pscan = reference.scan_arrays(
        *(np.asarray(a) for a in (scan.ranges, scan.angles, scan.mask)),
        "cpu", rel_sensor_pose=scan.rel_sensor_pose,
        num_valid=scan.num_valid, max_range=scan.max_range)
    init = node.global_pose - jslam.builder.latest_map_pose
    init = init + np.array([0.04, -0.03, 0.03])
    js = JFused(jm.ccfg, jm.lcfg, name="TorchParity.FJ").optimize_pose(
        ScanMatchingQuery(jraster, scan, init))
    ps = PFused(reference.correlative_config(dataclasses.asdict(jm.ccfg)),
                reference.linear_solver_config(dataclasses.asdict(jm.lcfg)),
                "cpu", name="TorchParity.FP").optimize_pose(
        PScanMatchingQuery(praster, pscan, init))
    assert js.pose_found and ps.pose_found
    np.testing.assert_allclose(ps.estimated_pose, js.estimated_pose, atol=1e-4)
    np.testing.assert_allclose(ps.covariance, js.covariance, rtol=1e-3,
                               atol=1e-3 * np.abs(js.covariance).max())
