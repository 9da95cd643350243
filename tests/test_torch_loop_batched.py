"""The port's batched loop detector (``parallel/loop_sharded.py``, the
default of ``create_default_backend``): its batched correlative core
against the port's serial core, the detector against the JAX package's
``LoopDetectorShardedCorrelative`` on a one-device mesh, and the default
backend end to end against the JAX package's.

Tolerances, fixed before the first run:
- batched against serial core: every field ``torch.equal``.  Each row of
  the batch runs the serial core's arithmetic on its own candidate, and
  nothing sums across candidates;
- detector against JAX: the same found flags, loop edges and scores (u8
  maps carried across as they are, integer sums times 1/255); relative
  poses within 1e-4 m / 1e-4 rad, because torch and XLA differ in the last
  ulp of ``asin`` in the theta step (ROADMAP 1.1), which moves the search
  poses and the GN refinement after them by a few f32 ulps;
- the default backend end to end: the same keyframes and loop edges,
  poses within ``E2E_TOL_XY`` / ``E2E_TOL_THETA`` of
  ``tests/test_torch_backend.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.datasets import synthetic as jsyn
from my_lidar_graph_slam_v2_tpu.graph.pose_graph import LocalMapNode as JMapNode
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
from my_lidar_graph_slam_v2_tpu.ops import quant as jquant
from my_lidar_graph_slam_v2_tpu.parallel.loop_sharded import (
    LoopDetectorShardedCorrelative as JSharded,
)
from my_lidar_graph_slam_v2_tpu.parallel.mesh import make_mesh
from my_lidar_graph_slam_v2_tpu.pipeline import factory as jfactory
from my_lidar_graph_slam_v2_tpu.sensor.data import ScanData as JScanData
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.core import pose as P
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic as psyn
from my_lidar_graph_slam_v2_tpu_torch.graph.pose_graph import LocalMapNode, ScanNode
from my_lidar_graph_slam_v2_tpu_torch.loop.detector import (
    LoopDetectorConfig,
    LoopDetectorCorrelative,
)
from my_lidar_graph_slam_v2_tpu_torch.matching.correlative import (
    ScanMatcherCorrelative,
    correlative_core,
    correlative_core_batch,
)
from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
    LinearSolverConfig,
    ScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, pool
from my_lidar_graph_slam_v2_tpu_torch.parallel.loop_sharded import (
    LoopDetectorShardedCorrelative,
)
from my_lidar_graph_slam_v2_tpu_torch.pipeline import factory
from my_lidar_graph_slam_v2_tpu_torch.sensor.data import ScanData

from tests.test_matchers import build_map, synth_world_scan
from tests.test_torch_backend import E2E_TOL_THETA, E2E_TOL_XY, FRONT, _drive, _sequence
from torch_counters import FetchesOf, dense_reruns, host_fetches
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

POSE_TOL = 1e-4
# Map poses of the two local maps and the detector's gates, as in
# tests/test_parallel.py:59-95.
MAP_POSES = (np.zeros(3), np.array([0.5, 0.3, 0.1]))
DETECTOR = dict(score_threshold=0.2, known_rate_threshold=0.1,
                beam_capacity=192, usable_range_max=12.0)
# 64 thetas with the top-32 prune and a 5 x 5-block window with the top-20
# block prune, so both certificates can fail.
MATCHER = dict(range_x=1.0, range_y=1.0, range_theta=0.4, n_theta_max=64,
               crop_rows=256, crop_cols=256, fine_block_b=20)


@pytest.fixture(scope="module")
def maps():
    """Two u8 local maps of the 6 m room (tests/test_parallel.py's),
    built and quantized by the JAX package: (prob, observed, offset)."""
    rng = np.random.default_rng(11)
    out = []
    for mp in MAP_POSES:
        gm, _ = build_map([mp] * 6, rng=rng)
        out.append((np.asarray(jquant.quantize_prob_f32(gm.prob)),
                    np.asarray(gm.observed), np.asarray(gm.offset_xy)))
    return out


def _scan(module, true_pose, seed, max_range=None):
    """A scan of the room from ``true_pose``; beams beyond ``max_range``
    dropped (fewer thetas in the window, so the top-K prune holds)."""
    ranges, angles = synth_world_scan(true_pose,
                                      rng=np.random.default_rng(seed))
    if max_range is not None:
        keep = ranges < max_range
        ranges, angles = ranges[keep], angles[keep]
    return module.ScanData("S", 0.0, true_pose, np.zeros(3), np.zeros(3),
                           0.0, 12.0, float(angles[0]), float(angles[-1]),
                           angles, ranges)


# (map, offset of the true pose from the map pose, offset of the node's
# guess from the true pose, beam range limit): two candidates on map 0,
# one on map 1 whose full-range scan fails the top-K certificate.
CANDIDATES = (
    (0, (0.3, -0.2, 0.15), (0.3, 0.2, 0.1), 3.2),
    (0, (-0.2, 0.25, -0.1), (-0.25, 0.2, -0.12), 3.2),
    (1, (0.3, -0.2, 0.15), (0.3, 0.2, 0.1), None),
)


def _queries(module, maps, local_map, scan_node, map_node, which=CANDIDATES):
    out = []
    for k, (m, true_off, guess_off, limit) in enumerate(which):
        true = MAP_POSES[m] + np.array(true_off)
        scan = _scan(module, true, seed=k, max_range=limit)
        node = scan_node(k, m, np.zeros(3), true + np.array(guess_off), scan)
        out.append(dict(query_node=node, ref_node=node, local_map=local_map(m),
                        local_map_node=map_node(m, MAP_POSES[m], True)))
    return out


def _port_queries(maps, which=CANDIDATES):
    lms = {m: reference.local_map(m, maps[m][2], "cpu", observed=maps[m][1],
                                  prob_q=maps[m][0])
           for m in range(len(maps))}
    return _queries(psyn, maps, lms.__getitem__, ScanNode, LocalMapNode,
                    which)


def _jax_queries(maps, which=CANDIDATES):
    import jax.numpy as jnp

    from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster

    def local_map(m):
        prob, obs, off = maps[m]
        lm = JLocalMap(m, None, jnp.asarray(obs), off, 0, 0, finished=True)
        raster = MapRaster(jnp.asarray(prob), jnp.asarray(obs), 0.05, off)
        lm.raster = lambda res: raster
        return lm

    return _queries(jsyn, maps, local_map, JScanNode, JMapNode, which)


def _core_inputs(maps, queries, cfg):
    """The batched core's inputs for ``queries`` (what the detector
    stages): map stacks, per-candidate beams, poses, offsets, map index."""
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import scan_arrays_batch

    (ranges, angles, mask), arrays = scan_arrays_batch(
        [q["query_node"].scan_data for q in queries], 192, "cpu")
    prob = torch.stack([torch.from_numpy(m[0].copy()) for m in maps])
    obs = torch.stack([torch.from_numpy(m[1].copy()) for m in maps])
    coarse = [pool.sliding_window_max2d(a, cfg.low_resolution)
              for a in (prob, obs)]
    index = torch.tensor([q["local_map"].local_map_id for q in queries])
    poses = torch.tensor(np.stack([
        P.inverse_compound(q["local_map_node"].global_pose,
                           q["query_node"].global_pose) for q in queries]),
        dtype=torch.float32)
    offsets = torch.tensor(np.stack([maps[i][2] for i in index.tolist()]),
                           dtype=torch.float32)
    return prob, obs, coarse, index, ranges, angles, mask, poses, offsets


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("dense", [False, True])
def test_batched_core_equals_serial_core(maps, n, dense):
    """Every field of every row equals the serial core's on that candidate
    alone: two candidates share map 0, the third fails the top-K theta
    certificate (``exact`` false) and its dense re-run runs too."""
    cfg = reference.correlative_config(MATCHER)
    which = CANDIDATES[-n:]
    prob, obs, coarse, index, ranges, angles, mask, poses, offsets = \
        _core_inputs(maps, _port_queries(maps, which), cfg)
    thr = (0.2, 0.1)
    batch = correlative_core_batch(
        cfg, prob, obs, *coarse, ranges, angles, mask, poses, offsets, *thr,
        map_index=index, dense=dense)
    for i in range(n):
        m = int(index[i])
        one = correlative_core(
            cfg, prob[m], obs[m], coarse[0][m], coarse[1][m], ranges[i],
            angles[i], mask[i], poses[i], offsets[i], *thr, dense=dense)
        for name, b, s in zip(("pose", "score", "known", "found", "ncost",
                               "cov", "n_processed", "n_total", "exact"),
                              batch, one):
            assert b.dtype == s.dtype, name
            assert torch.equal(b[i], s), (name, i, b[i], s)
    exact = batch[-1].tolist()
    if dense:
        assert all(exact)
    else:
        # the full-range candidate (last) alone fails its certificate
        assert exact == [True] * (n - 1) + [False]
        assert bool(batch[3].all())


def test_detector_equals_serial_detector(maps):
    """The batched detector gives the serial (unfused) correlative
    detector's loop edges bit for bit; the inexact candidate is re-run
    densely, and the step costs one fetch for the batch, one for the re-run
    and two sweep launches' worth of plain sweeps."""
    cfg = reference.correlative_config(MATCHER)
    dcfg = LoopDetectorConfig(**DETECTOR)
    final = ScanMatcherLinearSolver(LinearSolverConfig(), "cpu")
    batched = LoopDetectorShardedCorrelative(dcfg, cfg, final, "cpu")
    serial = LoopDetectorCorrelative(
        dcfg, ScanMatcherCorrelative(cfg, "cpu", "TorchBatched.Serial"), final)
    launches = csm_cuda.LAUNCHES
    f0, r0 = host_fetches(), dense_reruns()
    got = batched.detect(_port_queries(maps))
    # the batch's fetch and the re-run's, then one per final match
    fetched, reruns = host_fetches() - f0 - len(got), dense_reruns() - r0
    want = serial.detect(_port_queries(maps))
    assert csm_cuda.LAUNCHES == launches  # CPU tensors: the plain sweep
    assert reruns == 1 and fetched == 2
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_detector_matches_jax(maps):
    """The JAX package's batched detector on a one-device mesh and the
    port's, on tests/test_parallel.py's queries plus a third candidate
    that shares map 0 and one that is re-run densely."""
    jmcfg = JCorrelativeConfig(**MATCHER)
    jdet = JSharded(JLoopDetectorConfig(**DETECTOR), jmcfg,
                    JScanMatcherLinearSolver(JLinearSolverConfig()),
                    make_mesh(1))
    pdet = LoopDetectorShardedCorrelative(
        LoopDetectorConfig(**DETECTOR),
        reference.correlative_config(dataclasses.asdict(jmcfg)),
        ScanMatcherLinearSolver(LinearSolverConfig(), "cpu"), "cpu")
    j = jdet.detect(_jax_queries(maps))
    r0 = dense_reruns()
    p = pdet.detect(_port_queries(maps))
    assert dense_reruns() - r0 == 1
    assert len(p) == len(j) == 3
    for a, b in zip(p, j):
        assert (a["local_map_id"], a["scan_node_id"]) == \
            (b["local_map_id"], b["scan_node_id"])
        assert a["score"] == b["score"]
        np.testing.assert_allclose(a["relative_pose"], b["relative_pose"],
                                   atol=POSE_TOL, rtol=0)
    stack = pdet._launch(pdet.device, _port_queries(maps))["maps"]
    staged = sum(m.numel() * m.element_size() for m in stack)
    assert staged == 2 * 320 * 320 * 4  # two distinct maps


def test_default_backend_builds_the_batched_detector():
    for sharded in (None, True):
        b = factory.create_default_backend(device="cpu", sharded=sharded)
        assert isinstance(b.loop_detector, LoopDetectorShardedCorrelative)
        assert b.loop_detector.device == torch.device("cpu")


def test_default_backend_matches_jax():
    """``create_default_slam(backend=create_default_backend())`` in both
    packages on tests/test_torch_backend.py's world: the same keyframes and
    loop edges, poses within the e2e tolerances."""
    kw = dict(beam_capacity=256, usable_range_max=10.0, n_theta_max=64,
              searcher_overrides=dict(travel_dist_threshold=6.0))
    jbackend = jfactory.create_default_backend(**kw)
    assert isinstance(jbackend.loop_detector, JSharded)
    j_est, _, j_loops = _drive(
        jfactory.create_default_slam(backend=jbackend, **FRONT),
        _sequence(jsyn, step=0.2))
    backend = factory.create_default_backend(device="cpu", **kw)
    fetched = FetchesOf(backend.loop_detector, "match")
    slam = factory.create_default_slam(device="cpu", backend=backend, **FRONT)
    p_est, p_gt, p_loops = _drive(slam, _sequence(psyn, step=0.2))
    assert len(p_est) == len(j_est)
    assert p_loops == j_loops and len(p_loops) >= 1
    d = np.abs(p_est - j_est)
    assert d[:, :2].max() <= E2E_TOL_XY, d[:, :2].max()
    assert d[:, 2].max() <= E2E_TOL_THETA, d[:, 2].max()
    assert fetched.n >= 1
