"""The port's loop-closing backend against the JAX package: the robust
loss kernels, the LM pose-graph optimizer (dense and Schur) on a seeded
graph, the u8 map cache, and the whole loop-closing run with the
branch-and-bound detector on a small world, where both packages get the
same scans.

Tolerances, fixed before the first run:
- loss and weight: rtol 2e-6, f32 transcendental functions that may
  differ in the last ulp between torch and XLA; atol the smallest normal
  f32, because XLA flushes subnormal results to zero and torch keeps them
  (Welsch's exp(-t/s) at large t);
- optimizer: both run f32 Levenberg-Marquardt through different LAPACK
  builds, whose Cholesky rounds differently; poses within 1e-4 (m, rad),
  errors rtol 1e-3, the same iteration count and lambda;
- e2e: the same keyframes and the same list of loop edges; poses within
  0.01 m and 0.005 rad (as tests/test_torch_e2e_odometry.py: last-ulp
  trig and sigmoid can move a CSM endpoint by one cell, which the GN
  refinement and the LM solve absorb to well under a centimetre).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.datasets import synthetic
from my_lidar_graph_slam_v2_tpu.graph import loss as jloss
from my_lidar_graph_slam_v2_tpu.graph import optimizer as joptimizer
from my_lidar_graph_slam_v2_tpu.grid.builder import LocalMap as JLocalMap
from my_lidar_graph_slam_v2_tpu.grid.map_cache import DeviceMapCache as JCache
from my_lidar_graph_slam_v2_tpu.loop.detector import (
    LoopDetectorBranchBound as JLoopDetectorBranchBound,
)
from my_lidar_graph_slam_v2_tpu.loop.detector import (
    LoopDetectorConfig as JLoopDetectorConfig,
)
from my_lidar_graph_slam_v2_tpu.loop.searcher import (
    LoopSearcherConfig,
    LoopSearcherNearest,
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
from my_lidar_graph_slam_v2_tpu.pipeline import factory as jfactory
from my_lidar_graph_slam_v2_tpu.pipeline.backend import (
    LidarGraphSlamBackend as JBackend,
)
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic as port_synthetic
from my_lidar_graph_slam_v2_tpu_torch.graph import loss, optimizer
from my_lidar_graph_slam_v2_tpu_torch.grid.map_cache import DeviceMapCache
from my_lidar_graph_slam_v2_tpu_torch.loop.detector import (
    LoopDetectorBranchBound,
    LoopDetectorConfig,
)
from my_lidar_graph_slam_v2_tpu_torch.loop.searcher import (
    LoopSearcherConfig as PLoopSearcherConfig,
)
from my_lidar_graph_slam_v2_tpu_torch.loop.searcher import (
    LoopSearcherNearest as PLoopSearcherNearest,
)
from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
    LinearSolverConfig,
    ScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda
from my_lidar_graph_slam_v2_tpu_torch.pipeline import factory
from my_lidar_graph_slam_v2_tpu_torch.pipeline.backend import LidarGraphSlamBackend
from torch_counters import FetchesOf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOSS_RTOL = 2e-6
LOSS_ATOL = float(np.finfo(np.float32).tiny)
OPT_POSE_TOL = 1e-4
OPT_ERR_RTOL = 1e-3
E2E_TOL_XY = 0.01
E2E_TOL_THETA = 0.005


# ---- loss kernels ---------------------------------------------------------
@pytest.mark.parametrize("kind", jloss.LOSS_KINDS)
def test_loss_and_weight_equal_reference(kind):
    rng = np.random.default_rng(5)
    t = np.concatenate([
        [0.0, 1e-6, 0.01, 0.0100001],
        rng.uniform(0, 0.02, 40), rng.exponential(1.0, 40), [50.0, 1e4],
    ]).astype(np.float32)
    jl = jloss.LossFunction(kind, 0.01)
    pl = loss.LossFunction(**jl.__dict__)
    for fn in ("loss", "weight"):
        ref = np.asarray(getattr(jl, fn)(jnp.asarray(t)))
        got = getattr(pl, fn)(torch.as_tensor(t)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=LOSS_ATOL)


# ---- optimizer ------------------------------------------------------------
def _graph(seed=4, M=5, per_map=8):
    """A seeded map/scan graph: intra edges from every scan to its map,
    an inter edge from each map to the next map's first scan, the first
    scan pinned (info 1e9, clipped), and four loop edges with a robust
    weight; the poses start perturbed from the truth."""
    rng = np.random.default_rng(seed)
    N = M * per_map
    t = np.linspace(0, 1.6 * np.pi, N)
    truth_s = np.stack([4 * np.cos(t), 3 * np.sin(t), t + np.pi / 2], -1)
    truth_m = truth_s[::per_map].copy()
    edges = []

    def rel(m, s):
        d = truth_s[s] - truth_m[m]
        c, sn = np.cos(truth_m[m, 2]), np.sin(truth_m[m, 2])
        return np.array([c * d[0] + sn * d[1], -sn * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))])

    def info(scale):
        a = rng.normal(size=(3, 3))
        return scale * (np.eye(3) + 0.1 * (a @ a.T))

    for s in range(N):
        m = s // per_map
        edges.append((m, s, 0, rel(m, s) + rng.normal(0, 0.01, 3),
                      info(1e9 if s == 0 else 400.0)))
        if s % per_map == 0 and m > 0:
            edges.append((m - 1, s, 0, rel(m - 1, s) + rng.normal(0, 0.01, 3),
                          info(300.0)))
    for m, s in ((0, N - 3), (0, N - 1), (1, N - 2), (2, 5)):
        edges.append((m, s, 1, rel(m, s) + rng.normal(0, 0.02, 3), info(50.0)))
    mi, si, il, rl, im = (np.array(x) for x in zip(*edges))
    mp = truth_m + rng.normal(0, 0.05, truth_m.shape)
    mp[0] = truth_m[0]
    sp = truth_s + rng.normal(0, 0.08, truth_s.shape)
    return mp, sp, (mi.astype(np.int32), si.astype(np.int32),
                    il.astype(np.int32), rl, im)


@pytest.mark.parametrize("solver", ["dense", "schur"])
@pytest.mark.parametrize("kind", ["Huber", "DCS"])
def test_optimizer_equals_reference(solver, kind):
    mp, sp, edges = _graph()
    jcfg = joptimizer.OptimizerConfig(
        solver=solver, loss=jloss.LossFunction(kind, 0.01)
    )
    jopt = joptimizer.PoseGraphOptimizer(jcfg)
    popt = optimizer.PoseGraphOptimizer(
        reference.optimizer_config(
            dict(jcfg.__dict__, loss=jcfg.loss.__dict__)),
        device="cpu",
    )
    for call in range(2):  # the second call starts from the kept lambda
        jm, js, jst = jopt.optimize(mp, sp, edges)
        pm, ps, pst = popt.optimize(mp, sp, edges)
        assert pst["iterations"] == jst["iterations"] >= 1
        assert popt.lam == pytest.approx(jopt.lam, rel=0)
        np.testing.assert_allclose(pm, jm, atol=OPT_POSE_TOL, rtol=0)
        np.testing.assert_allclose(ps, js, atol=OPT_POSE_TOL, rtol=0)
        for k in ("error", "initial_error"):
            assert pst[k] == pytest.approx(jst[k], rel=OPT_ERR_RTOL)
        assert pst["error"] <= pst["initial_error"]
        if call == 0:
            assert pst["error"] < 0.5 * pst["initial_error"]
        mp, sp = pm, ps


def test_schur_pairs_are_the_reference_pairs():
    """The vectorized pair list holds the JAX double loop's pairs: every
    ordered pair of edges sharing a scan node, and each edge with itself."""
    scan_idx = np.random.default_rng(2).integers(0, 9, 40)
    a, b = optimizer.schur_pairs(scan_idx)
    ref = {(i, i) for i in range(40)}
    ref |= {(i, j) for i in range(40) for j in range(40)
            if i != j and scan_idx[i] == scan_idx[j]}
    assert sorted(zip(a.tolist(), b.tolist())) == sorted(ref)


def test_optimizer_no_edges_is_a_no_op():
    mp, sp = np.zeros((1, 3)), np.zeros((2, 3))
    empty = (np.zeros(0, np.int32),) * 3 + (np.zeros((0, 3)),
                                           np.zeros((0, 3, 3)))
    out = optimizer.PoseGraphOptimizer(device="cpu").optimize(mp, sp, empty)
    assert out[2]["iterations"] == 0 and out[0] is mp


# ---- map cache ------------------------------------------------------------
def _map_state(i, seed):
    rng = np.random.default_rng(seed)
    lo = rng.normal(0, 2, (96, 80)).astype(np.float32)
    obs = rng.uniform(size=(96, 80)) < 0.6
    return lo, obs, np.array([-2.0 - i, -2.4])


def test_map_cache_equals_reference():
    """Same u8 rasters, offsets, LRU order and counters as the JAX cache;
    a compacted map hands its u8 raster over as is; a version bump is a
    miss; an entry's coarse dict persists across hits."""
    jc = JCache(0.05, max_entries=2, metrics=JMetricManager())
    pc = DeviceMapCache(0.05, max_entries=2, metrics=MetricManager())
    jmaps, pmaps = [], []
    for i in range(3):
        lo, obs, off = _map_state(i, 10 + i)
        jmaps.append(JLocalMap(i, jnp.asarray(lo), jnp.asarray(obs), off,
                               0, 0, finished=True))
        pmaps.append(reference.local_map(i, off, "cpu", logodds=lo,
                                         observed=obs))
    # a compacted map: the cache must use its u8 raster as is
    lo, obs, off = _map_state(3, 20)
    jmaps.append(JLocalMap(3, jnp.asarray(lo), jnp.asarray(obs), off, 0, 0,
                           finished=True))
    jmaps[-1].compact()
    pmaps.append(reference.local_map(3, off, "cpu", observed=obs,
                                     prob_q=np.asarray(jmaps[-1].prob_q)))
    for k in (0, 1, 0, 2, 1, 3, 3):
        jr, pr = jc.raster(jmaps[k]), pc.raster(pmaps[k])
        assert pr.prob.dtype == torch.uint8
        np.testing.assert_array_equal(pr.prob.numpy(), np.asarray(jr.prob))
        np.testing.assert_array_equal(pr.observed.numpy(),
                                      np.asarray(jr.observed))
        np.testing.assert_array_equal(pr.offset_xy, jr.offset_xy)
        assert list(pc._entries) == list(jc._entries)
        assert pc.stats == jc.stats
    assert pc.raster(pmaps[3]).prob is pmaps[3].prob_q
    pc.raster(pmaps[3]).coarse["k"] = 1
    assert pc.raster(pmaps[3]).coarse == {"k": 1}
    pmaps[3].version += 1
    hits = pc.stats["misses"]
    assert pc.raster(pmaps[3]).coarse == {}
    assert pc.stats["misses"] == hits + 1


# ---- loop-closing e2e with branch-and-bound -------------------------------
FRONT = dict(map_rows=512, map_cols=512, beam_capacity=256,
             samples_per_beam=320, usable_range_max=10.0, n_theta_max=64,
             crop=320)
BB = dict(n_theta_max=64, crop_rows=384, crop_cols=384)
LOOP = dict(beam_capacity=256, usable_range_max=10.0)


def _sequence(module, step=0.16):
    """The world of tests/test_e2e_loop.py: a 10 m office, 1.15 laps."""
    world = module.World.office(seed=1, size=10.0)
    traj = module.loop_trajectory(size=10.0, laps=1.15, step=step)
    return module.generate(world, traj, n_beams=141, max_range=10.0,
                           range_noise=0.01, odom_noise=(0.05, 0.02), seed=7)


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
def bb_runs():
    """The serial branch-and-bound detector in both packages, built the
    same way (``scripts/eval_ate.py``'s config #3 assigns a B&B matcher
    that its batched detector never reads, so it is not copied)."""
    searcher = dict(travel_dist_threshold=6.0)
    jbackend = JBackend(
        LoopSearcherNearest(LoopSearcherConfig(**searcher)),
        JLoopDetectorBranchBound(
            JLoopDetectorConfig(**LOOP),
            jfactory.create_scan_matcher("BranchBound", **BB),
            JScanMatcherLinearSolver(JLinearSolverConfig()),
        ),
        joptimizer.PoseGraphOptimizer(joptimizer.OptimizerConfig()),
    )
    jslam = jfactory.create_default_slam(backend=jbackend, **FRONT)
    j = _drive(jslam, _sequence(synthetic))

    matcher = factory.create_scan_matcher("BranchBound", device="cpu", **BB)
    backend = LidarGraphSlamBackend(
        PLoopSearcherNearest(PLoopSearcherConfig(**searcher)),
        LoopDetectorBranchBound(
            LoopDetectorConfig(**JLoopDetectorConfig(**LOOP).__dict__),
            matcher, ScanMatcherLinearSolver(LinearSolverConfig(), "cpu"),
        ),
        optimizer.PoseGraphOptimizer(device="cpu"),
    )
    fetched = FetchesOf(matcher)
    launches = (csm_cuda.LAUNCHES, hit_images_cuda.LAUNCHES)
    slam = factory.create_default_slam(device="cpu", backend=backend, **FRONT)
    p = _drive(slam, _sequence(port_synthetic))
    # CPU tensors take the plain versions: no kernel launched
    assert (csm_cuda.LAUNCHES, hit_images_cuda.LAUNCHES) == launches
    return j, p, slam, matcher, jbackend, backend, fetched


def test_bb_loop_run_matches_reference(bb_runs):
    (j_est, j_gt, j_loops), (p_est, p_gt, p_loops) = bb_runs[:2]
    assert len(p_est) == len(j_est) >= 30
    assert p_loops == j_loops and len(p_loops) >= 1
    d = np.abs(p_est - j_est)
    assert d[:, :2].max() <= E2E_TOL_XY, d[:, :2].max()
    assert d[:, 2].max() <= E2E_TOL_THETA, d[:, 2].max()


def test_bb_loop_run_closes_the_loop(bb_runs):
    (p_est, p_gt, _), slam, matcher = bb_runs[1], bb_runs[2], bb_runs[3]
    fetched = bb_runs[6]
    seq = _sequence(port_synthetic)
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = port_synthetic.ate_rmse(p_est, p_gt)
    assert ate < 0.6 * port_synthetic.ate_rmse(odom, seq.ground_truth)
    assert ate < 0.05, ate
    # every match swept at least one block and fetched once per block,
    # once for the bounds and once for the result
    assert matcher.matches >= 1
    assert fetched.n == matcher.blocks_swept + 2 * matcher.matches
    # each matched map's pyramid sits in its cache entry, built once
    entries = slam.backend.loop_detector.map_cache._entries.values()
    assert len(entries) >= 1
    assert all(list(e.coarse) == [("pyr", 3)] for e in entries)


def test_bb_backend_configs_match_reference(bb_runs):
    jbackend, backend = bb_runs[4], bb_runs[5]
    jd, pd = jbackend.loop_detector, backend.loop_detector
    assert reference.branch_bound_config(jd.scan_matcher.cfg.__dict__) == \
        pd.scan_matcher.cfg
    assert LoopDetectorConfig(**jd.cfg.__dict__) == pd.cfg
    jo = jbackend.optimizer.cfg
    assert reference.optimizer_config(
        dict(jo.__dict__, loss=jo.loss.__dict__)) == backend.optimizer.cfg


# ---- the default backend's serial form ------------------------------------
def test_default_backend_serial_run():
    """``create_default_backend(sharded=False)``: the fused correlative
    detector at crop 448 closes the loop of a short world; the default
    builds the batched detector (``tests/test_torch_loop_batched.py``)."""
    from my_lidar_graph_slam_v2_tpu_torch.parallel.loop_sharded import (
        LoopDetectorShardedCorrelative,
    )

    seq = _sequence(port_synthetic, step=0.2)
    kw = dict(beam_capacity=256, usable_range_max=10.0, n_theta_max=64,
              searcher_overrides=dict(travel_dist_threshold=6.0))
    assert isinstance(
        factory.create_default_backend(device="cpu", **kw).loop_detector,
        LoopDetectorShardedCorrelative)
    backend = factory.create_default_backend(device="cpu", sharded=False, **kw)
    fetched = FetchesOf(backend.loop_detector.scan_matcher)
    slam = factory.create_default_slam(device="cpu", backend=backend, **FRONT)
    est, gt, loops = _drive(slam, seq)
    assert len(loops) >= 1
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = port_synthetic.ate_rmse(est, gt)
    assert ate < 0.6 * port_synthetic.ate_rmse(odom, seq.ground_truth)
    assert fetched.n >= 1


# ---- the worker thread ----------------------------------------------------
def test_threaded_backend_closes_the_loop():
    """``inline=False``: the backend steps run on the worker thread behind
    the backpressure wait; the run finishes and closes the loop."""
    seq = _sequence(port_synthetic, step=0.2)
    backend = LidarGraphSlamBackend(
        PLoopSearcherNearest(PLoopSearcherConfig(travel_dist_threshold=6.0)),
        LoopDetectorBranchBound(
            LoopDetectorConfig(**LOOP),
            factory.create_scan_matcher("BranchBound", device="cpu", **BB),
            ScanMatcherLinearSolver(LinearSolverConfig(), "cpu"),
        ),
        optimizer.PoseGraphOptimizer(device="cpu"),
        inline=False,
    )
    slam = factory.create_default_slam(device="cpu", backend=backend, **FRONT)
    slam.start_backend()
    est, gt, loops = _drive(slam, seq)
    assert slam.backend_thread_steps >= 1 and slam.backend_error is None
    assert len(loops) >= 1
    odom = np.stack([s.odom_pose for s in seq.scans])
    assert port_synthetic.ate_rmse(est, gt) < port_synthetic.ate_rmse(
        odom, seq.ground_truth)


def test_dead_worker_ends_the_backpressure_wait():
    """A backend step that raises kills the worker; the frontend's
    backpressure wait ends and re-raises instead of hanging (the JAX
    facade waits forever here, ROADMAP 3.2)."""
    import threading

    class Failing:
        inline = False

        def run_step(self, parent):
            raise ValueError("backend step failed")

    slam = factory.create_default_slam(device="cpu", backend=Failing(),
                                       **FRONT)
    slam.max_backend_lag = 1
    slam.pose_graph.scan_nodes.extend([None] * 5)  # 5 keyframes ahead
    slam.start_backend()
    raised = []

    def frontend():
        try:
            slam.notify_backend()
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=frontend, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the frontend hung on a dead worker"
    assert len(raised) == 1
    assert isinstance(raised[0].__cause__, ValueError)


@pytest.mark.parametrize("name,exc", [("GridSearch", None),
                                      ("HillClimbing", None),
                                      ("NoSuchMatcher", ValueError)])
def test_create_scan_matcher_refuses_what_is_not_ported(name, exc):
    """Every matcher of the JAX package builds on the given device; an
    unknown name raises."""
    if exc is not None:
        with pytest.raises(exc):
            factory.create_scan_matcher(name, device="cpu")
    else:
        assert factory.create_scan_matcher(name, device="cpu").device == \
            torch.device("cpu")
    for ported in ("RealTimeCorrelative", "LinearSolver", "BranchBound"):
        assert factory.create_scan_matcher(ported, device="cpu").device == \
            torch.device("cpu")
