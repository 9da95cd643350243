"""The port's frontend slice end to end against the JAX package, on the
world and sizes of tests/test_e2e_odometry.py (odometry-only SLAM, no
loop closure): the same scans go through both ``create_default_slam``s.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.datasets import synthetic
from my_lidar_graph_slam_v2_tpu.pipeline.factory import (
    create_default_slam as jax_create_default_slam,
)
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic as port_synthetic
from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda
from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import create_default_slam
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = dict(map_rows=512, map_cols=512, beam_capacity=512,
             samples_per_beam=320, usable_range_max=10.0, n_theta_max=96,
             crop=320)

# Tolerances, fixed before the first run.  Keyframes are gated by odometry
# alone, so their count must be equal.  Poses: 0.01 m (a fifth of a cell)
# and 0.005 rad (two theta search steps at 10 m range).  Both packages run
# the same algorithm in f32; the only differences are last-ulp trig,
# sigmoid and summation-order effects, which can move a u8 level or a
# CSM candidate's endpoint by one cell, and GN refinement absorbs such a
# move to well under a centimetre.
POSE_TOL_XY = 0.01
POSE_TOL_THETA = 0.005


def _sequence(module):
    world = module.World.office(seed=1, size=10.0)
    traj = module.loop_trajectory(size=10.0, laps=0.25, step=0.08)
    return module.generate(world, traj, n_beams=181, max_range=10.0,
                           range_noise=0.01, odom_noise=(0.03, 0.01), seed=2)


def _drive(slam, seq):
    gt = []
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    return slam.get_trajectory(), np.asarray(gt)


@pytest.fixture(scope="module")
def runs():
    seq = _sequence(synthetic)
    port_seq = _sequence(port_synthetic)
    jslam = jax_create_default_slam(**SIZES)
    j_est, j_gt = _drive(jslam, seq)
    launches = csm_cuda.LAUNCHES
    slam = create_default_slam(device="cpu", **SIZES)
    p_est, p_gt = _drive(slam, port_seq)
    assert csm_cuda.LAUNCHES == launches  # CPU tensors take the plain sweep
    return seq, port_seq, slam, (j_est, j_gt), (p_est, p_gt), jslam


def test_port_synthetic_sequence_is_the_reference(runs):
    seq, port_seq = runs[:2]
    np.testing.assert_array_equal(port_seq.ground_truth, seq.ground_truth)
    for a, b in zip(port_seq.scans, seq.scans):
        np.testing.assert_array_equal(a.ranges, b.ranges)
        np.testing.assert_array_equal(a.odom_pose, b.odom_pose)


def test_trajectory_matches_reference(runs):
    seq, _, _, (j_est, j_gt), (p_est, p_gt), _ = runs
    assert len(p_est) == len(j_est) >= 10
    d = np.abs(p_est - j_est)
    assert d[:, :2].max() <= POSE_TOL_XY, d[:, :2].max()
    assert d[:, 2].max() <= POSE_TOL_THETA, d[:, 2].max()
    ate = synthetic.ate_rmse(p_est, p_gt)
    assert ate < 0.05, f"ATE {ate:.3f} m"
    odom = np.stack([s.odom_pose for s in seq.scans])
    assert ate < synthetic.ate_rmse(odom, seq.ground_truth)


def test_pose_graph_and_maps(runs):
    _, _, slam, _, (p_est, _), _ = runs
    pg = slam.pose_graph
    assert len(pg.scan_nodes) == len(p_est)
    intra = [e for e in pg.edges if e.edge_type == 0]
    assert len(intra) == len(pg.scan_nodes)
    for n in pg.local_map_nodes[:-1]:
        assert n.finished
    assert all(lm.compacted for lm in slam.builder.local_maps[:-1])
    _, raster = slam.get_global_map()
    prob = raster.prob.numpy()
    occupied = (prob > 0.55).sum()
    assert occupied > 200
    assert ((prob > 0) & (prob < 0.5)).sum() > 10 * occupied


def test_factory_configs_match_reference(runs):
    """Both factories build the same configs: the JAX ones, carried over
    by ``reference``, equal the port's field for field."""
    slam, jslam = runs[2], runs[-1]
    pairs = [
        (reference.correlative_config, jslam.frontend.scan_matcher.ccfg,
         slam.frontend.scan_matcher.ccfg),
        (reference.linear_solver_config, jslam.frontend.scan_matcher.lcfg,
         slam.frontend.scan_matcher.lcfg),
        (reference.builder_config, jslam.builder.cfg, slam.builder.cfg),
        (reference.frontend_config, jslam.frontend.cfg, slam.frontend.cfg),
    ]
    for convert, jcfg, pcfg in pairs:
        assert convert(dataclasses.asdict(jcfg)) == pcfg
