"""The port's runtime protocol against ``tests/test_async_pipeline.py``:
the threaded backend beside the inline one, the frontend's wait on an
optimization pass, the matcher-failure fallback to odometry and the
backend-lag backpressure with a slow live backend.

Both packages run where the JAX test's subject is a function of data
(the inline run, the odometry fallback); the port runs alone where the
subject is a protocol with stub backends.  Bars, fixed before the first
run:
- inline: the same keyframes and loop-edge count as the JAX package, the
  port's ATE within 0.005 m of the JAX run's (the same bar as
  ``chip_smoke.py``'s multi-device phases), both below the JAX test's
  0.12 m;
- threaded: at least one backend step on the worker thread, a loop edge,
  ATE below 0.12 m (ROADMAP 3.11: the worker's pace moves the loop
  closures, so its ATE is bounded, not compared);
- the odometry fallback: every keyframe after the first fails over, and
  the trajectory equals the JAX one within 1e-6 (both are the odometry
  chain, composed in f64 on the host).
"""
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.datasets import synthetic as jsynthetic
from my_lidar_graph_slam_v2_tpu.matching.types import (
    ScanMatchingSummary as JSummary,
)
from my_lidar_graph_slam_v2_tpu.pipeline import factory as jfactory
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.matching.types import ScanMatchingSummary
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu_torch.pipeline import factory
from my_lidar_graph_slam_v2_tpu_torch.pipeline.slam import LidarGraphSlam
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATE_TOL = 0.005
ATE_MAX = 0.12
ODOM_TOL = 1e-6


# ---- threaded vs inline (tests/test_async_pipeline.py:52) ------------------
def _world(module):
    world = module.World.office(seed=21, size=10.0)
    traj = module.loop_trajectory(size=10.0, laps=1.25, step=0.3)
    return module.generate(world, traj, n_beams=121, max_range=10.0,
                           range_noise=0.01, odom_noise=(0.05, 0.02), seed=22)


def _async_run(fac, module, inline, **dev):
    seq = _world(module)
    backend = fac.create_default_backend(
        usable_range_max=10.0, n_theta_max=48, crop=256, beam_capacity=256,
        inline=inline, searcher_overrides=dict(travel_dist_threshold=10.0,
                                               node_dist_threshold=5.0),
        **dev)
    slam = fac.create_default_slam(
        map_rows=384, map_cols=384, beam_capacity=256, samples_per_beam=192,
        usable_range_max=10.0, n_theta_max=48, crop=256, backend=backend,
        builder_overrides=dict(travel_dist_threshold=1.5), **dev)
    slam.start_backend()
    gt = []
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    slam.stop_backend()
    est = slam.get_trajectory()
    return dict(slam=slam, keyframes=len(est),
                ate=module.ate_rmse(est, np.asarray(gt)),
                loops=sum(1 for e in slam.pose_graph.edges if e.is_loop))


@pytest.fixture(scope="module")
def async_runs():
    return dict(
        jax_inline=_async_run(jfactory, jsynthetic, True),
        inline=_async_run(factory, synthetic, True, device="cpu"),
        threaded=_async_run(factory, synthetic, False, device="cpu"),
    )


def test_inline_backend_matches_reference(async_runs):
    j, p = async_runs["jax_inline"], async_runs["inline"]
    assert p["keyframes"] == j["keyframes"]
    assert p["loops"] == j["loops"] >= 1
    assert abs(p["ate"] - j["ate"]) <= ATE_TOL, (p["ate"], j["ate"])
    assert p["ate"] < ATE_MAX and j["ate"] < ATE_MAX
    assert p["slam"].backend_thread_steps == 0


def test_threaded_backend_closes_loops_within_the_bound(async_runs):
    t = async_runs["threaded"]
    slam = t["slam"]
    assert slam.backend_thread_steps >= 1 and slam.backend_error is None
    assert t["loops"] >= 1
    assert t["ate"] < ATE_MAX, t["ate"]


# ---- wait_for_optimization (tests/test_async_pipeline.py:67) ---------------
class NoopBuilder:
    local_maps = []
    accum_travel_dist = 0.0


class Node:
    pass


def _stub_slam(backend, **kw):
    slam = LidarGraphSlam(frontend=None, backend=backend,
                          builder=NoopBuilder(), **kw)
    assert slam.inline_backend is False
    return slam


def _stop(slam):
    slam._backend_stop.set()
    slam._backend_thread.join(timeout=10)
    assert not slam._backend_thread.is_alive()


def test_wait_for_optimization_blocks():
    """The frontend blocks while a (slow) optimization pass rewrites
    poses, and resumes when it is done; the wait is observed into
    ``Frontend.OptimizationWaitTime``."""

    class SlowBackend:
        inline = False

        def __init__(self):
            self.steps = 0

        def run_step(self, parent):
            parent.notify_optimization_started()
            try:
                time.sleep(0.3)
                self.steps += 1
            finally:
                parent.notify_optimization_done()
            return True

    waits = MetricManager.instance().value_sequence(
        "Frontend.OptimizationWaitTime")
    n_before = len(waits.values)
    slam = _stub_slam(SlowBackend())
    slam.start_backend()
    slam.notify_backend()
    time.sleep(0.1)  # let the worker enter the optimization section
    t0 = time.perf_counter()
    slam.wait_for_optimization()
    waited = time.perf_counter() - t0
    _stop(slam)
    assert slam.opt_wait_count == 1
    assert waited > 0.1, f"frontend did not block ({waited:.3f}s)"
    assert slam.backend.steps == 1 and slam.backend_thread_steps == 1
    assert len(waits.values) == n_before + 1
    assert waits.values[-1] >= 100_000  # us
    # No pass running: no wait counted
    slam.wait_for_optimization()
    assert slam.opt_wait_count == 1


# ---- backend-lag backpressure (tests/test_async_pipeline.py:153) -----------
class LaggingBackend:
    inline = False

    def __init__(self):
        self.steps = 0

    def run_step(self, parent):
        time.sleep(0.25)
        self.steps += 1
        return True


def test_backend_lag_backpressure_blocks_on_a_live_backend():
    """Ten keyframes ahead of the last completed step with a bound of 5:
    the frontend blocks until the slow, live worker completes a step."""
    waits = MetricManager.instance().value_sequence(
        "Frontend.BackendLagWaitTime")
    n_before = len(waits.values)
    slam = _stub_slam(LaggingBackend(), max_backend_lag=5)
    slam.start_backend()
    slam.pose_graph.scan_nodes.extend(Node() for _ in range(10))
    t0 = time.perf_counter()
    slam.notify_backend()  # lag 10 > 5: blocks until a step completes
    waited = time.perf_counter() - t0
    _stop(slam)
    assert slam.lag_wait_count == 1
    assert waited > 0.2, f"frontend did not block on lag ({waited:.3f}s)"
    assert slam.backend.steps >= 1 and slam.backend_error is None
    assert slam._backend_done_nodes == 10
    assert len(waits.values) == n_before + 1


def test_backend_lag_within_the_bound_does_not_block():
    slam = _stub_slam(LaggingBackend(), max_backend_lag=5)
    slam.pose_graph.scan_nodes.extend(Node() for _ in range(3))
    slam.start_backend()
    t0 = time.perf_counter()
    slam.notify_backend()
    fast = time.perf_counter() - t0
    _stop(slam)
    assert slam.lag_wait_count == 0
    assert fast < 0.1


# ---- matcher failure (tests/test_async_pipeline.py:110) --------------------
def _failing_run(fac, module, summary_cls, **dev):
    class FailingMatcher:
        def optimize_pose(self, query):
            return summary_cls(
                pose_found=False,
                normalized_cost=float("inf"),
                initial_pose=query.initial_pose,
                estimated_pose=query.initial_pose,
                covariance=np.eye(3),
            )

    world = module.World.office(seed=3, size=8.0)
    traj = module.loop_trajectory(size=8.0, laps=0.15, step=0.3)
    seq = module.generate(world, traj, n_beams=61, max_range=8.0,
                          range_noise=0.01, odom_noise=(0.01, 0.005), seed=4)
    slam = fac.create_default_slam(
        map_rows=256, map_cols=256, beam_capacity=128, samples_per_beam=128,
        usable_range_max=8.0, n_theta_max=16, crop=128, **dev)
    slam.frontend.scan_matcher = FailingMatcher()
    n_kf = sum(1 for scan in seq.scans
               if slam.process_scan(scan, scan.odom_pose))
    return slam, n_kf


def test_matcher_failure_falls_back_to_odometry():
    jslam, j_kf = _failing_run(jfactory, jsynthetic, JSummary)
    slam, n_kf = _failing_run(factory, synthetic, ScanMatchingSummary,
                              device="cpu")
    assert n_kf == j_kf >= 3
    assert len(slam.pose_graph.scan_nodes) == n_kf
    fails = slam.frontend._m_matcher_failure.value
    assert fails == n_kf - 1 == jslam.frontend._m_matcher_failure.value
    est, jest = slam.get_trajectory(), jslam.get_trajectory()
    assert np.all(np.isfinite(est))
    np.testing.assert_allclose(est, jest, atol=ODOM_TOL, rtol=0)
