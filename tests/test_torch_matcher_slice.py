"""The slice of the settings path that runs the remaining matchers, in both
packages: ``create_slam_from_settings`` with a HillClimbing frontend and a
GridSearch loop detector, inline, on a small synthetic world.

The frontend's climber uses SquareError (the reference's pairing with
GreedyEndpoint is ``tests/test_torch_greedy_slice.py``); the loop matcher
is GridSearch
at 1.0 m x 1.0 m x 0.3 rad with a 0.01 rad theta step (T = 31, 21 x 21
offsets, so JAX takes its conv branch), SquareError winner cost.

Tolerances, fixed before the first run (those of
``tests/test_torch_backend.py``'s e2e test): the same keyframes and the same
loop edges; poses within 0.01 m and 0.005 rad (last-ulp trig can move a
beam's cell, which the linear-solver refinement and the LM absorb).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.config import settings as jsettings
from my_lidar_graph_slam_v2_tpu.datasets import synthetic as jsyn
from my_lidar_graph_slam_v2_tpu_torch.config import settings as psettings
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic as psyn
from my_lidar_graph_slam_v2_tpu_torch.matching.grid_search import (
    ScanMatcherGridSearch,
)
from my_lidar_graph_slam_v2_tpu_torch.matching.hill_climbing import (
    ScanMatcherHillClimbing,
)
from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda
from torch_counters import FetchesOf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from tests.test_torch_backend import E2E_TOL_THETA, E2E_TOL_XY

SETTINGS = {
    "Frontend": {"LocalSlam": {
        "ScanMatcherType": "HillClimbing",
        "ScanMatcherConfigGroup": "ScanMatcherHillClimbing"}},
    "ScanMatcherHillClimbing": {"CostType": "SquareError"},
    "GridMapBuilder": {"UsableRangeMax": 6.0},
    "ScanOutlierFilter": {"ValidRangeMax": 6.0},
    "LoopSearcherNearest": {"TravelDistThreshold": 6.0},
    "Backend": {"LoopDetectorConfigGroup": "LoopDetectorGridSearch"},
    "LoopDetectorGridSearch": {
        "ScanMatcherType": "GridSearch",
        "ScanMatcher": {"SearchRangeX": 1.0, "SearchRangeY": 1.0,
                        "SearchRangeTheta": 0.3, "SearchStepTheta": 0.01}},
}
SIZES = dict(map_rows=256, map_cols=256, crop=256, loop_crop=256,
             n_theta_max=64, inline_backend=True)


def _sequence(module):
    """A 6 m office, 1.15 laps at 0.2 m steps (the launcher test's world)."""
    return module.generate(
        module.World.office(seed=1, size=6.0),
        module.loop_trajectory(size=6.0, laps=1.15, step=0.2),
        n_beams=121, max_range=6.0, range_noise=0.01,
        odom_noise=(0.05, 0.02), seed=7)


def _drive(slam, seq):
    gt = []
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    slam.stop_backend()
    loops = [(e.local_map_node_id, e.scan_node_id)
             for e in slam.pose_graph.edges if e.is_loop]
    return slam.get_trajectory(), np.asarray(gt), loops


@pytest.fixture(scope="module")
def runs():
    j = _drive(jsettings.create_slam_from_settings(SETTINGS, **SIZES),
               _sequence(jsyn))
    launches = csm_cuda.LAUNCHES
    slam = psettings.create_slam_from_settings(SETTINGS, device="cpu", **SIZES)
    fetched = (FetchesOf(slam.frontend.scan_matcher),
               FetchesOf(slam.backend.loop_detector.scan_matcher))
    p = _drive(slam, _sequence(psyn))
    assert csm_cuda.LAUNCHES == launches  # CPU tensors: plain versions
    return j, p, slam, fetched


def test_matcher_slice_matches_reference(runs):
    (j_est, _, j_loops), (p_est, _, p_loops) = runs[:2]
    assert len(p_est) == len(j_est) >= 20
    assert p_loops == j_loops and len(p_loops) >= 1
    d = np.abs(p_est - j_est)
    assert d[:, :2].max() <= E2E_TOL_XY, d[:, :2].max()
    assert d[:, 2].max() <= E2E_TOL_THETA, d[:, 2].max()


def test_matcher_slice_runs_the_new_matchers(runs):
    (p_est, p_gt, _), slam, (front_fetched, loop_fetched) = runs[1:]
    front = slam.frontend.scan_matcher
    loop = slam.backend.loop_detector.scan_matcher
    assert isinstance(front, ScanMatcherHillClimbing)
    assert isinstance(loop, ScanMatcherGridSearch)
    assert front.matches == len(p_est) - 1
    assert front_fetched.n == front.iterations + 2 * front.matches
    assert loop.matches >= 1 and loop_fetched.n == loop.matches
    seq = _sequence(psyn)
    odom = np.stack([s.odom_pose for s in seq.scans])
    assert psyn.ate_rmse(p_est, p_gt) < 0.5 * psyn.ate_rmse(
        odom, seq.ground_truth)
