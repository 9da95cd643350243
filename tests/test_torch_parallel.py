"""The port's multi-device layer (``parallel/mesh.py``,
``parallel/distributed.py``, ``parallel/multihost.py``,
``pipeline/factory.py:create_distributed_backend``) against the JAX
package on its 8-device virtual CPU mesh (``tests/conftest.py``), the port
on a mesh of eight ``"cpu"`` shards.

Tolerances, fixed before the first run, and why:
- distributed LM against the port's single-device Schur LM: bitwise, at 1,
  8 and 64 shards (64 leaves shards without edges).  Both sum in f64 and
  round once; a one-shard mesh sums in the same order, and more shards
  only reorder f64 sums far below the f32 rounding;
- distributed LM against JAX's (``tests/test_parallel.py:24-35``): poses
  within 1e-4, error rtol 1e-3, as ``tests/test_torch_backend.py``'s
  optimizer test (f32 LM against f64 rounded once);
- mesh-fanned detector against JAX's sharded detector at mesh sizes 8 and 1
  (``tests/test_parallel.py:38-110``'s two maps, with
  ``tests/test_torch_loop_batched.py``'s three candidates): the same
  found flags, loop edges and scores, relative poses within 1e-4, as that
  file's one-device test; the port's mesh sizes among themselves bitwise
  (each candidate's arithmetic runs alone on its row);
- ``create_distributed_backend`` through ``tests/test_e2e_distributed.py``'s
  small pipeline against JAX's: the same keyframes and loop edges, poses
  within the e2e tolerances of ``tests/test_torch_backend.py`` (0.01 m,
  0.005 rad) and ATE within 0.005 m;
- owner retention and ``drop_heavy`` against JAX's on the same map list:
  equal holdings, counts and dropped ids (pure bookkeeping);
- checkpoint with a dropped map: the held state bit for bit, the dropped
  map restored dropped with its extent and offset.
"""
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.datasets import synthetic as jsyn
from my_lidar_graph_slam_v2_tpu.graph.optimizer import (
    OptimizerConfig as JOptimizerConfig,
)
from my_lidar_graph_slam_v2_tpu.graph.pose_graph import ScanNode as JScanNode
from my_lidar_graph_slam_v2_tpu.grid.builder import LocalMap as JLocalMap
from my_lidar_graph_slam_v2_tpu.loop.detector import (
    LoopDetectorConfig as JLoopDetectorConfig,
)
from my_lidar_graph_slam_v2_tpu.matching.correlative import (
    CorrelativeConfig as JCorrelativeConfig,
)
from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
    LinearSolverConfig as JLinearSolverConfig,
)
from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
    ScanMatcherLinearSolver as JScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu.parallel import multihost as jmultihost
from my_lidar_graph_slam_v2_tpu.parallel.distributed import (
    DistributedPoseGraphOptimizer as JDistributed,
)
from my_lidar_graph_slam_v2_tpu.parallel.loop_sharded import (
    LoopDetectorShardedCorrelative as JSharded,
)
from my_lidar_graph_slam_v2_tpu.parallel.mesh import make_mesh as jmake_mesh
from my_lidar_graph_slam_v2_tpu.pipeline import factory as jfactory
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic as psyn
from my_lidar_graph_slam_v2_tpu_torch.graph.optimizer import (
    OptimizerConfig,
    PoseGraphOptimizer,
)
from my_lidar_graph_slam_v2_tpu_torch.graph.pose_graph import ScanNode
from my_lidar_graph_slam_v2_tpu_torch.loop.detector import LoopDetectorConfig
from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
    LinearSolverConfig,
    ScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda
from my_lidar_graph_slam_v2_tpu_torch.parallel import multihost
from my_lidar_graph_slam_v2_tpu_torch.parallel.distributed import (
    DistributedPoseGraphOptimizer,
    partition_edges,
)
from my_lidar_graph_slam_v2_tpu_torch.parallel.loop_sharded import (
    LoopDetectorShardedCorrelative,
)
from my_lidar_graph_slam_v2_tpu_torch.parallel.mesh import make_mesh
from my_lidar_graph_slam_v2_tpu_torch.pipeline import checkpoint, factory
from torch_counters import dense_reruns, host_fetches
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from tests.test_optimizer import build_loop_graph
from tests.test_torch_backend import E2E_TOL_THETA, E2E_TOL_XY
from tests.test_torch_loop_batched import (  # noqa: F401 (fixture)
    DETECTOR,
    MATCHER,
    POSE_TOL,
    _jax_queries,
    _port_queries,
    maps,
)

OPT_POSE_TOL = 1e-4
OPT_ERR_RTOL = 1e-3
E2E_ATE_TOL = 0.005
CPU8 = ("cpu",) * 8


# ---- mesh -----------------------------------------------------------------
def test_make_mesh_takes_the_given_devices_and_never_the_cpu_by_default(
        monkeypatch):
    assert make_mesh(CPU8) == (torch.device("cpu"),) * 8
    assert make_mesh([torch.device("cpu")]) == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh([])


# ---- distributed Schur LM -------------------------------------------------
def test_partition_keeps_scan_groups_and_deals_them_round_robin():
    scan_idx = np.array([3, 0, 3, 1, 2, 0, 5, 1])
    shards = partition_edges(scan_idx, 3)
    # groups in scan order 0, 1, 2, 3, 5 -> shards 0, 1, 2, 0, 1
    assert [s.tolist() for s in shards] == [[0, 1, 2, 5], [3, 6, 7], [4]]


@pytest.mark.parametrize("n_shards", [1, 8, 64])
def test_distributed_lm_equals_single_device_lm(n_shards):
    _, _, mp, sp, edges = build_loop_graph()
    single = PoseGraphOptimizer(OptimizerConfig(), device="cpu")
    dist = DistributedPoseGraphOptimizer(("cpu",) * n_shards)
    for _ in range(2):  # the second call starts from the kept lambda
        m1, s1, st1 = single.optimize(mp, sp, edges)
        m2, s2, st2 = dist.optimize(mp, sp, edges)
        assert np.array_equal(m2, m1) and np.array_equal(s2, s1)
        assert (st2["iterations"], st2["error"]) == (st1["iterations"],
                                                     st1["error"])
        assert dist.lam == single.lam
        mp, sp = m2, s2


@pytest.mark.parametrize("n_dev", [None, 1])
def test_distributed_lm_matches_jax(n_dev):
    _, _, mp, sp, edges = build_loop_graph()
    jdist = JDistributed(jmake_mesh(n_dev), JOptimizerConfig())
    pdist = DistributedPoseGraphOptimizer(CPU8 if n_dev is None else ("cpu",))
    jm, js, jst = jdist.optimize(mp, sp, edges)
    pm, ps, pst = pdist.optimize(mp, sp, edges)
    assert pst["iterations"] == jst["iterations"] >= 1
    np.testing.assert_allclose(pm, jm, atol=OPT_POSE_TOL, rtol=0)
    np.testing.assert_allclose(ps, js, atol=OPT_POSE_TOL, rtol=0)
    assert pst["error"] == pytest.approx(jst["error"], rel=OPT_ERR_RTOL)
    assert pdist.lam == pytest.approx(jdist.lam, rel=0)


def test_distributed_lm_no_edges_is_a_no_op():
    mp, sp = np.zeros((1, 3)), np.zeros((2, 3))
    empty = (np.zeros(0, np.int32),) * 3 + (np.zeros((0, 3)),
                                           np.zeros((0, 3, 3)))
    out = DistributedPoseGraphOptimizer(CPU8).optimize(mp, sp, empty)
    assert out[2]["iterations"] == 0 and out[0] is mp


# ---- mesh-fanned loop detector --------------------------------------------
@pytest.mark.parametrize("n_dev", [None, 1])
def test_mesh_detector_matches_jax(maps, n_dev):
    """Three candidates (two on map 0, one re-run densely) over JAX's
    8-device (or 1-device) mesh and the port's 8 (or 1) CPU shards."""
    jmcfg = JCorrelativeConfig(**MATCHER)
    jdet = JSharded(JLoopDetectorConfig(**DETECTOR), jmcfg,
                    JScanMatcherLinearSolver(JLinearSolverConfig()),
                    jmake_mesh(n_dev))
    mesh = CPU8 if n_dev is None else ("cpu",)
    pdet = LoopDetectorShardedCorrelative(
        LoopDetectorConfig(**DETECTOR),
        reference.correlative_config(MATCHER),
        ScanMatcherLinearSolver(LinearSolverConfig(), "cpu"), mesh)
    launches = csm_cuda.LAUNCHES
    j = jdet.detect(_jax_queries(maps))
    f0, r0 = host_fetches(), dense_reruns()
    p = pdet.detect(_port_queries(maps))
    assert csm_cuda.LAUNCHES == launches  # CPU tensors: the plain sweep
    # the batch's fetch and the re-run's, then one per final match
    assert host_fetches() - f0 == 2 + len(p) and dense_reruns() - r0 == 1
    assert len(p) == len(j) == 3
    for a, b in zip(p, j):
        assert (a["local_map_id"], a["scan_node_id"]) == \
            (b["local_map_id"], b["scan_node_id"])
        assert a["score"] == b["score"]
        np.testing.assert_allclose(a["relative_pose"], b["relative_pose"],
                                   atol=POSE_TOL, rtol=0)


def test_mesh_detector_sizes_agree_bitwise(maps):
    """1, 2, 3 and 8 shards: the same results bit for bit, in query
    order; each chunk stages only its own maps."""
    out = []
    for n in (1, 2, 3, 8):
        det = LoopDetectorShardedCorrelative(
            LoopDetectorConfig(**DETECTOR),
            reference.correlative_config(MATCHER),
            ScanMatcherLinearSolver(LinearSolverConfig(), "cpu"),
            ("cpu",) * n)
        f0 = host_fetches()
        out.append(det.detect(_port_queries(maps)))
        assert host_fetches() - f0 == 2 + len(out[-1])
    for got in out[1:]:
        assert [r.keys() for r in got] == [r.keys() for r in out[0]]
        for g, w in zip(got, out[0]):
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---- the distributed pipeline ---------------------------------------------
def _office10(module):
    """tests/test_e2e_distributed.py's world."""
    return module.generate(
        module.World.office(seed=21, size=10.0),
        module.loop_trajectory(size=10.0, laps=1.25, step=0.3),
        n_beams=121, max_range=10.0, range_noise=0.01,
        odom_noise=(0.05, 0.02), seed=22)


SMALL = dict(map_rows=384, map_cols=384, beam_capacity=256,
             samples_per_beam=192, usable_range_max=10.0, n_theta_max=48,
             crop=256, builder_overrides=dict(travel_dist_threshold=1.5))
DIST = dict(usable_range_max=10.0, n_theta_max=48, crop=256,
            beam_capacity=256,
            searcher_overrides=dict(travel_dist_threshold=10.0,
                                    node_dist_threshold=5.0))


def _drive(slam, seq):
    gt = []
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    slam.stop_backend()
    loops = [(e.local_map_node_id, e.scan_node_id)
             for e in slam.pose_graph.edges if e.is_loop]
    return slam.get_trajectory(), np.asarray(gt), loops


def test_distributed_pipeline_matches_jax():
    jbackend = jfactory.create_distributed_backend(jmake_mesh(), **DIST)
    j_est, j_gt, j_loops = _drive(
        jfactory.create_default_slam(backend=jbackend, **SMALL),
        _office10(jsyn))
    backend = factory.create_distributed_backend(CPU8, **DIST)
    assert backend.loop_detector.mesh == make_mesh(CPU8)
    p_est, p_gt, p_loops = _drive(
        factory.create_default_slam(device="cpu", backend=backend, **SMALL),
        _office10(psyn))
    assert len(p_est) == len(j_est)
    assert p_loops == j_loops and len(p_loops) >= 1
    d = np.abs(p_est - j_est)
    assert d[:, :2].max() <= E2E_TOL_XY, d[:, :2].max()
    assert d[:, 2].max() <= E2E_TOL_THETA, d[:, 2].max()
    p_ate, j_ate = psyn.ate_rmse(p_est, p_gt), jsyn.ate_rmse(j_est, j_gt)
    assert abs(p_ate - j_ate) <= E2E_ATE_TOL and p_ate < 0.12


# ---- owner retention, drop_heavy, checkpoint ------------------------------
CFG = types.SimpleNamespace(num_scans_for_latest_map=4, num_overlapped_scans=4)


def _map_list(module_is_jax):
    """Eight local maps of five scans each (the last open, 0-3 compacted)
    and 40 scan nodes holding a scan, for the JAX package or the port."""
    rng = np.random.default_rng(5)
    lms, nodes = [], []
    for i in range(8):
        lo = rng.normal(0, 2, (64, 48)).astype(np.float32)
        obs = rng.uniform(size=(64, 48)) < 0.6
        off = np.array([-1.6 - i, -1.2])
        if module_is_jax:
            lm = JLocalMap(i, jnp.asarray(lo), jnp.asarray(obs), off,
                           5 * i, 5 * i + 4, finished=i < 7)
        else:
            lm = reference.local_map(i, off, "cpu", logodds=lo, observed=obs,
                                     finished=i < 7)
            lm.scan_node_id_min, lm.scan_node_id_max = 5 * i, 5 * i + 4
        if i < 4:
            lm.compact()
        lms.append(lm)
    node = JScanNode if module_is_jax else ScanNode
    for k in range(40):
        nodes.append(node(k, k // 5, np.zeros(3), np.zeros(3), "scan"))
    builder = types.SimpleNamespace(local_maps=lms, cfg=CFG,
                                    latest_scan_id_min=30)
    return types.SimpleNamespace(scan_nodes=nodes), builder


def _holdings(pg, builder):
    return ([(lm.local_map_id, lm.holds_raster, lm.dropped, lm.compacted,
              tuple(lm.shape)) for lm in builder.local_maps],
            [n.scan_data is None for n in pg.scan_nodes])


@pytest.mark.parametrize("pid", [0, 1])
def test_owner_retention_equals_jax(pid):
    jpg, jb = _map_list(True)
    ppg, pb = _map_list(False)
    kw = dict(num_processes=2, process_id=pid)
    for _ in range(2):  # idempotent
        jret = jmultihost.apply_owner_retention(jpg, jb, **kw)
        pret = multihost.apply_owner_retention(ppg, pb, **kw)
        assert pret == jret
        assert _holdings(ppg, pb) == _holdings(jpg, jb)
    assert pret["rasters_held"] < 8 and pret["scan_buffers_held"] < 40
    dropped = [lm for lm in pb.local_maps if lm.dropped]
    assert dropped and all(lm.local_map_id % 2 != pid for lm in dropped)
    assert all(lm.logodds is None and lm.observed is None
               and lm.prob_q is None for lm in dropped)
    with pytest.raises(RuntimeError, match="owner"):
        dropped[0].raster(0.05)
    # one process: nothing is dropped
    ppg, pb = _map_list(False)
    assert multihost.apply_owner_retention(
        ppg, pb, num_processes=1, process_id=0)["rasters_held"] == 8


def test_owner_of_equals_jax():
    for m in range(10):
        for n in (1, 2, 3):
            assert multihost.owner_of(m, n) == jmultihost.owner_of(m, n)


def _ckpt_slam():
    return factory.create_default_slam(
        device="cpu", map_rows=256, map_cols=256, beam_capacity=128,
        samples_per_beam=128, usable_range_max=8.0, n_theta_max=16,
        crop=128, builder_overrides=dict(travel_dist_threshold=0.8,
                                         num_scans_for_latest_map=3,
                                         num_overlapped_scans=3))


def test_checkpoint_round_trip_with_dropped_maps(tmp_path):
    """Rank 1 of two drops its non-owned aged-out maps and scans, saves,
    and a fresh system loads exactly that state back."""
    seq = psyn.generate(psyn.World.office(seed=4, size=8.0),
                        psyn.loop_trajectory(size=8.0, laps=0.6, step=0.25),
                        n_beams=91, max_range=8.0, seed=5)
    slam = _ckpt_slam()
    for s in seq.scans:
        slam.process_scan(s, s.odom_pose)
        multihost.apply_owner_retention(slam.pose_graph, slam.builder,
                                        num_processes=2, process_id=1)
    maps = slam.builder.local_maps
    assert any(lm.dropped for lm in maps) and any(lm.holds_raster
                                                  for lm in maps)
    checkpoint.save(slam, str(tmp_path / "rank1"))
    restored = checkpoint.load(_ckpt_slam(), str(tmp_path / "rank1"))
    assert [n.scan_data is None for n in restored.pose_graph.scan_nodes] == \
        [n.scan_data is None for n in slam.pose_graph.scan_nodes]
    for a, b in zip(restored.builder.local_maps, maps, strict=True):
        assert (a.holds_raster, a.dropped, a.compacted, a.shape) == \
            (b.holds_raster, b.dropped, b.compacted, b.shape)
        np.testing.assert_array_equal(a.offset_xy, b.offset_xy)
        for k in ("logodds", "prob_q", "observed"):
            va, vb = getattr(a, k), getattr(b, k)
            assert (va is None) == (vb is None), k
            if va is not None:
                assert torch.equal(va, vb), k
    np.testing.assert_array_equal(restored.get_trajectory(),
                                  slam.get_trajectory())


def test_global_map_sharded_without_a_group_holds_every_scan():
    """One process, no process group: the sharded global map integrates
    every scan on the pose-derived extent."""
    seq = psyn.generate(psyn.World.office(seed=4, size=8.0),
                        psyn.loop_trajectory(size=8.0, laps=0.3, step=0.25),
                        n_beams=91, max_range=8.0, seed=5)
    slam = _ckpt_slam()
    for s in seq.scans:
        slam.process_scan(s, s.odom_pose)
    pose, gmap = multihost.construct_global_map_sharded(slam)
    assert np.array_equal(pose, slam.pose_graph.scan_nodes[0].global_pose)
    assert gmap.prob.shape == gmap.observed.shape
    assert gmap.prob.shape[0] % 128 == 0 and gmap.prob.shape[1] % 128 == 0
    assert int(gmap.observed.sum()) > 1000
