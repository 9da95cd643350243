"""Whole runs of the port on the card: the committed head-to-head logs
through the launcher, the measurement scripts, the threaded runtime and
the soak at the factory widths.  They import no JAX and skip without a
GPU.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_runs.py -q

The bars were fixed before the first run on the card.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda
from my_lidar_graph_slam_v2_tpu_torch.scripts import eval_ate
from torch_card_cases import (
    async_sequence,
    cuda_device,  # noqa: F401 (fixture)
    soak_sequence,
)
from torch_counters import PerCall

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
# Head to head: synth7 and synth11 as the CPU test (tests/test_torch_h2h.py)
# holds them; synth3 at the binary's 997 nodes and at least its 366 loop
# edges; ATE at or below the binary's and at most the JAX artifact's plus
# the slack.
H2H_SLACK = 0.005
# The threaded run's ATE bound (tests/test_async_pipeline.py).
ASYNC_ATE_MAX = 0.12
# The soak: the map cache holds at most SOAK_CACHE_ENTRIES maps; host RSS
# may grow by at most SOAK_RSS_MB over the run; a local map every
# SOAK_LOCAL_MAP_M of travel; device memory read every SOAK_MEMORY_EVERY
# keyframes.
SOAK_CACHE_ENTRIES = 16
SOAK_RSS_MB = 1500
SOAK_LOCAL_MAP_M = 1.5
SOAK_MEMORY_EVERY = 50


@pytest.mark.parametrize("seed", [7, 11, 3])
def test_head_to_head_log_on_the_card(cuda_device, seed, tmp_path):
    """A committed log ``h2h/synth{seed}.clf`` through the port's launcher
    in a subprocess on the card, with the reference binary's settings
    (``scripts/head_to_head.py:head_to_head``): the binary's nodes, its
    loop edges (synth3: at least as many), sweep launches, and ATE at or
    below the binary's and at most 0.005 m above the JAX artifact's."""
    from my_lidar_graph_slam_v2_tpu_torch.scripts import head_to_head

    r = head_to_head.head_to_head(seed, tmp_path, device="cuda")
    ours, ref, jax_art = r["ours"], r["reference"], r["jax_artifact"]
    assert ours["nodes"] == ref["nodes"] == jax_art["nodes"]
    if seed == 3:
        assert ours["loop_edges"] >= ref["loop_edges"]
    else:
        assert ours["loop_edges"] == ref["loop_edges"]
    assert ours["device_report"]["csm_sweep_launches"] > 0
    assert ours["ate_m"] <= ref["ate_m"]
    assert ours["ate_m"] <= jax_art["ate_m"] + H2H_SLACK


def test_bench_csm_measures_on_the_card(cuda_device):
    """``scripts/bench_csm.py``'s measurement: the C++ baseline's live rate
    in its subprocess, the batched core's matches/s at batch 8 and 16,
    sweep launches on the card."""
    from my_lidar_graph_slam_v2_tpu_torch.scripts import bench_csm

    s0 = csm_cuda.LAUNCHES
    bench = bench_csm.measure(cuda_device, bench_csm.build_workload())
    assert bench["value"] > 0 and bench["value_batch16"] > 0
    assert csm_cuda.LAUNCHES > s0


@pytest.mark.parametrize("name,kw", eval_ate.configs(),
                         ids=[n for n, _ in eval_ate.configs()])
def test_eval_ate_config_on_the_card(cuda_device, monkeypatch, name, kw):
    """``scripts/eval_ate.py``'s configuration: the keyframes of
    ``results_ate.json``, ATE below odometry's, a loop edge where it runs
    a backend, and for #3 a hit-image launch a branch-and-bound match."""
    from my_lidar_graph_slam_v2_tpu_torch.matching import branch_bound

    cls = branch_bound.ScanMatcherBranchBound
    optimize_pose, matches = cls.optimize_pose, []

    def counted(self, *args, **kwargs):
        matches.append(1)
        return optimize_pose(self, *args, **kwargs)

    monkeypatch.setattr(cls, "optimize_pose", counted)
    recorded = {r["config"]: r for r in json.loads(
        (ROOT / "results_ate.json").read_text())}
    h0 = hit_images_cuda.LAUNCHES
    r = eval_ate.run_config(name, device=cuda_device, **kw)
    assert r["keyframes"] == recorded[name]["keyframes"]
    assert r["ate_m"] < r["ate_odometry_m"]
    if kw["backend_kind"] is not None:
        assert r["loop_edges"] >= 1
    if kw["backend_kind"] == "branchbound":
        assert len(matches) >= 1
        assert hit_images_cuda.LAUNCHES - h0 >= len(matches)


def test_bench_e2e_on_the_card(cuda_device):
    """``scripts/bench_e2e.py`` at 200 keyframes with the threaded
    backend: ATE below odometry's."""
    from my_lidar_graph_slam_v2_tpu_torch.scripts import bench_e2e

    e2e = bench_e2e.run(200, threaded=True, progress=False,
                        device=cuda_device)
    assert e2e["keyframes"] > 100
    assert e2e["ate_rmse_m"] < e2e["ate_odometry_m"]


def test_eval_bb_pyramid_on_the_card(cuda_device):
    """``scripts/eval_bb_pyramid.py`` at the JAX script's sizes:
    branch-and-bound's score is the dense sweep's gated argmax on both
    maps, and it sweeps fewer blocks on the peaked map."""
    from my_lidar_graph_slam_v2_tpu_torch.scripts import eval_bb_pyramid

    s0, h0 = csm_cuda.LAUNCHES, hit_images_cuda.LAUNCHES
    bb = eval_bb_pyramid.run(cuda_device)
    for name in ("noise", "peaked"):
        m = bb[f"{name}_map"]
        assert m["bb_found"] and m["dense_found"], m
        assert m["bb_score"] == m["dense_gated_best_score"], m
    assert (bb["peaked_map"]["bb_blocks_swept"]
            < bb["noise_map"]["bb_blocks_swept"])
    assert csm_cuda.LAUNCHES > s0 and hit_images_cuda.LAUNCHES > h0


def test_eval_scaling_on_one_card(cuda_device):
    from my_lidar_graph_slam_v2_tpu_torch.scripts import eval_scaling

    s0 = csm_cuda.LAUNCHES
    r = eval_scaling.run(cuda_device, [1])["results"][0]
    assert r["devices"] == 1 and r["loop_candidates_per_s"] > 0
    assert r["schur_lm_iterations"] >= 1
    assert csm_cuda.LAUNCHES > s0


def test_eval_scaling_pipeline_on_one_card(cuda_device):
    """``scripts/eval_scaling_pipeline.py``: P = 1 and 2 gloo workers on
    the card give the same keyframes, ATE and trajectory."""
    from my_lidar_graph_slam_v2_tpu_torch.scripts import (
        eval_scaling_pipeline,
    )

    pipe = eval_scaling_pipeline.run(cuda_device)
    assert pipe["ate_identical"] and pipe["trajectory_identical"]
    assert pipe["ranks_bitwise_equal"]
    assert pipe["p1"]["keyframes"] == pipe["p2"]["keyframes"]
    assert min(pipe["p2"]["csm_sweep_launches"]) > 0


def run_async(device, seq, inline):
    """``tests/test_async_pipeline.py``'s system (384^2 maps, 256 beams,
    192 samples, 48 thetas, crop 256, the default batched backend, a local
    map every 1.5 m) over ``seq``, inline or with the backend on its
    worker thread."""
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )

    backend = create_default_backend(
        device=device, usable_range_max=10.0, n_theta_max=48, crop=256,
        beam_capacity=256, inline=inline,
        searcher_overrides=dict(travel_dist_threshold=10.0,
                                node_dist_threshold=5.0))
    slam = create_default_slam(
        device=device, map_rows=384, map_cols=384, beam_capacity=256,
        samples_per_beam=192, usable_range_max=10.0, n_theta_max=48,
        crop=256, backend=backend,
        builder_overrides=dict(travel_dist_threshold=1.5))
    slam.start_backend()
    gt = []
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    slam.stop_backend()
    est = slam.get_trajectory()
    return dict(slam=slam, est=est,
                ate_m=synthetic.ate_rmse(est, np.asarray(gt)),
                loops=sum(1 for e in slam.pose_graph.edges if e.is_loop))


@pytest.fixture(scope="module")
def async_world():
    return async_sequence()


def test_async_pipeline_inline_on_the_card_is_the_cpus(cuda_device,
                                                       async_world):
    gpu = run_async(cuda_device, async_world, True)
    cpu = run_async("cpu", async_world, True)
    assert gpu["loops"] == cpu["loops"] >= 1
    np.testing.assert_array_equal(gpu["est"], cpu["est"])
    assert gpu["ate_m"] < ASYNC_ATE_MAX


def test_async_pipeline_threaded_on_the_card(cuda_device, async_world):
    """The backend on its worker thread: at least one worker step, no
    backend error, ATE below 0.12 m."""
    run = run_async(cuda_device, async_world, False)
    slam = run["slam"]
    assert slam.backend_thread_steps >= 1 and slam.backend_error is None
    assert run["ate_m"] < ASYNC_ATE_MAX


def test_soak_on_the_card(cuda_device):
    """The soak on the main path at full width: ``create_default_slam``
    and ``create_default_backend()`` (the batched detector) at the
    factory widths (1024^2 maps, 512 beams, 768 samples, 208 thetas, crop
    320, the detector's crop 448), inline, with ``usable_range_max=12``,
    a local map every 1.5 m and a map cache of 16 entries, over
    ``tests/test_soak.py``'s course.  Its invariants: at least 300
    keyframes, more than 64 local maps, at least 10 loop edges, no
    out-of-extent hit, cache evictions and hits with at most 16 entries,
    host RSS growth below 1,500 MB; ATE below odometry's, the other runs'
    bar (the JAX test's bars, below 0.30 m and half of odometry's, are
    missed on this course by both packages: ROADMAP 3.17).  The card's
    counterpart of the JAX test's jit-cache bounds: no kernel built during
    the run (all four are built before it), and the same sweep launches
    in every frontend match without a dense re-run (and that number plus
    the same number per re-run in the others).  Device memory: its growth
    from keyframe 50 to the end within a bound computed before the run
    from the course's length: twice the compacted maps' bytes (a u8 prob
    and a bool observed per cell of each local map the course can start)
    plus 16 cache entries of three such planes (u8 prob, bool observed, a
    pooled u8 coarse map)."""
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )
    from my_lidar_graph_slam_v2_tpu_torch.ops import cuda_build
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )
    from my_lidar_graph_slam_v2_tpu_torch.utils.memory import (
        physical_memory_usage,
    )

    device = cuda_device
    cuda_build.build("csm_sweep", "csm_sweep_f32", "hit_images",
                     "gauss_newton")
    mm = MetricManager.instance()
    mm.reset_all()
    seq = soak_sequence()
    gt_all = np.asarray(seq.ground_truth)
    travel = float(np.hypot(*np.diff(gt_all[:, :2], axis=0).T).sum())
    backend = create_default_backend(device=device, usable_range_max=12.0,
                                     inline=True)
    cache = backend.loop_detector.map_cache
    cache.max_entries = SOAK_CACHE_ENTRIES
    slam = create_default_slam(
        device=device, usable_range_max=12.0, backend=backend,
        builder_overrides=dict(travel_dist_threshold=SOAK_LOCAL_MAP_M))
    cfg = slam.builder.cfg
    cells = cfg.local_map_rows * cfg.local_map_cols
    max_maps = math.ceil(travel / SOAK_LOCAL_MAP_M) + 1
    mem_bound = 2 * (max_maps * 2 * cells + SOAK_CACHE_ENTRIES * 3 * cells)

    builds = []
    build = cuda_build.build

    def counted_build(*names):
        out = build(*names)
        builds.extend(n for n, info in out.items() if not info["cached"])
        return out

    matcher = slam.frontend.scan_matcher
    reruns = mm.counter(f"{matcher.name}.DenseFallbacks")
    counters = dict(sweeps=lambda: csm_cuda.LAUNCHES,
                    reruns=lambda: int(reruns.value))
    matches = [PerCall(matcher, m, **counters)
               for m in ("optimize_pose", "optimize_pose_deltas")]
    cuda_build.build = counted_build
    torch.cuda.synchronize(device)
    curve = []
    rss0 = physical_memory_usage()
    gt = []
    try:
        for scan, g in zip(seq.scans, seq.ground_truth):
            if slam.process_scan(scan, scan.odom_pose):
                gt.append(g)
                if len(gt) % SOAK_MEMORY_EVERY == 0:
                    curve.append(torch.cuda.memory_allocated(device))
        slam.stop_backend()
        torch.cuda.synchronize(device)
    finally:
        cuda_build.build = build
    curve.append(torch.cuda.memory_allocated(device))
    rss_growth_mb = (physical_memory_usage() - rss0) / 2 ** 20

    est = slam.get_trajectory()
    odom = np.stack([s.odom_pose for s in seq.scans])
    assert slam.process_count >= 300
    assert len(slam.builder.local_maps) > 64
    assert sum(1 for e in slam.pose_graph.edges if e.is_loop) >= 10
    assert (synthetic.ate_rmse(est, np.asarray(gt))
            < synthetic.ate_rmse(odom, gt_all[:len(odom)]))
    assert mm.counter("GridMapBuilder.OutOfExtentHits").value == 0
    assert cache.stats["evictions"] > 0 and cache.stats["hits"] > 0
    assert len(cache._entries) <= SOAK_CACHE_ENTRIES
    assert rss_growth_mb < SOAK_RSS_MB
    assert not builds
    calls = [c for m in matches for c in m.calls]
    plain = {c["sweeps"] for c in calls if c["reruns"] == 0}
    per_rerun = {(c["sweeps"] - min(plain, default=0)) / c["reruns"]
                 for c in calls if c["reruns"]}
    assert len(plain) == 1 and len(per_rerun) <= 1, (plain, per_rerun)
    assert curve[-1] - curve[0] <= mem_bound
