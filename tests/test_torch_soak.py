"""Reference-scale soak of the port: ``tests/test_soak.py`` on the CPU.

The same course (a 12 m office, 8 laps at 0.3 m, 91 beams, seed 7), the
same sizes (512^2 maps, 128 beams, 256 samples, 48 thetas, crop 256, the
serial detector inline, a new local map every 1.5 m, a map cache of 16
entries) and the same invariants: at least 300 keyframes, more than 64
local maps, at least 10 loop edges, ATE below 0.30 m and half of
odometry's, no out-of-extent hit, cache evictions and hits with at most
16 entries, and host RSS growth below 1,500 MB.  The JAX test's
jit-cache bounds have no counterpart in eager PyTorch; ``chip_smoke.py``
phase 17b holds the card's (no kernel built during the run, constant
sweep launches per keyframe) at the factory widths.  The map cache's
``stats`` is read as the property it is in both packages (the JAX test
calls it, ROADMAP 3.17).

On this course both packages miss the ATE bars: the JAX package's run of
``tests/test_soak.py``'s system ends at 0.545 m and the port's at 0.577 m
against odometry's 0.509 m (CPU), the frontend sliding along the
corridors (ROADMAP 3.17).  The bars are kept as the JAX test states
them, so this test fails on its ATE assert as the JAX one does.

Slow tier (``-m slow``): ``JAX_PLATFORMS=cpu python -m pytest -m slow
tests/test_torch_soak.py -q``.  Imports no JAX.
"""
import numpy as np
import pytest

from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
    create_default_backend,
    create_default_slam,
)
from my_lidar_graph_slam_v2_tpu_torch.utils.memory import physical_memory_usage
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.slow
def test_reference_scale_soak():
    mm = MetricManager.instance()
    mm.reset_all()

    world = synthetic.World.office(seed=7, size=12.0)
    traj = synthetic.loop_trajectory(size=12.0, laps=8.0, step=0.3)
    seq = synthetic.generate(
        world, traj, n_beams=91, max_range=12.0, range_noise=0.01,
        odom_noise=(0.02, 0.008), seed=7,
    )

    backend = create_default_backend(
        device="cpu", n_theta_max=48, crop=256, beam_capacity=128,
        usable_range_max=12.0, inline=True, sharded=False,
    )
    backend.loop_detector.map_cache.max_entries = 16
    slam = create_default_slam(
        device="cpu", map_rows=512, map_cols=512, beam_capacity=128,
        samples_per_beam=256, usable_range_max=12.0, n_theta_max=48,
        crop=256, backend=backend,
        builder_overrides=dict(travel_dist_threshold=1.5),
    )
    slam.start_backend()

    rss0 = physical_memory_usage()
    gt = []
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    slam.stop_backend()

    est = slam.get_trajectory()
    ate = synthetic.ate_rmse(est, np.asarray(gt))
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth[: len(odom)])

    n_maps = len(slam.builder.local_maps)
    n_loops = sum(1 for e in slam.pose_graph.edges if e.is_loop)
    assert slam.process_count >= 300, slam.process_count
    assert n_maps > 64, n_maps
    assert n_loops >= 10, n_loops

    assert ate < 0.30, (ate, ate_odom)
    assert ate < 0.5 * ate_odom, (ate, ate_odom)

    assert mm.counter("GridMapBuilder.OutOfExtentHits").value == 0

    cache = backend.loop_detector.map_cache
    stats = cache.stats
    assert stats["evictions"] > 0, stats
    assert stats["hits"] > 0, stats
    assert len(cache._entries) <= 16

    rss_growth_mb = (physical_memory_usage() - rss0) / 2**20
    assert rss_growth_mb < 1500, rss_growth_mb
