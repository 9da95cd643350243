"""The port's branch-and-bound pieces against the JAX package on the scene
of tests/test_more_matchers.py, its map quantized to u8 (the form the map
cache hands the loop detector): the max pyramid and the u8 window sweep
``sweep_from_hits`` bit for bit, and the whole B&B core with the same
winner.

Tolerances, fixed before the first run: the score is a sum of exact
integers times the same f32 factors, so it must be equal; the pose is the
winner's offsets times f32 steps, equal up to the last-ulp ``asin`` of the
theta step (1e-6); cost and covariance go through bilinear map reads with
trig that rounds differently in torch and XLA, rtol 1e-4 and 1e-3.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.matching.branch_bound import (
    BranchBoundConfig as JBranchBoundConfig,
)
from my_lidar_graph_slam_v2_tpu.matching.branch_bound import (
    ScanMatcherBranchBound as JScanMatcherBranchBound,
)
from my_lidar_graph_slam_v2_tpu.matching.branch_bound import _branch_bound_core
from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster, ScanMatchingQuery
from my_lidar_graph_slam_v2_tpu.ops import csm as jcsm
from my_lidar_graph_slam_v2_tpu.ops import pool as jpool
from my_lidar_graph_slam_v2_tpu.ops import quant as jquant
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.matching import branch_bound
from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
    ScanMatchingQuery as PScanMatchingQuery,
)
from my_lidar_graph_slam_v2_tpu_torch.ops import csm, pool

from tests.test_matchers import build_map, make_scan_arrays
from torch_counters import FetchesOf, host_fetches
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

POSE_TOL = 1e-6
COST_RTOL = 1e-4
COV_RTOL = 1e-3


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(21)
    true_pose = np.array([0.35, -0.25, 0.12])
    gm, _ = build_map(
        [np.array([0.0, 0.0, 0.0])] * 16 + [true_pose] * 16, rng=rng
    )
    prob_q = np.asarray(jquant.quantize_prob_f32(gm.prob))
    obs = np.asarray(gm.observed)
    jgm = MapRaster(jnp.asarray(prob_q), jnp.asarray(obs), gm.resolution,
                    gm.offset_xy)
    pgm = reference.map_raster(prob_q, obs, gm.offset_xy, gm.resolution, "cpu")
    scan = make_scan_arrays(true_pose)
    pscan = reference.scan_arrays(
        *(np.array(a) for a in (scan.ranges, scan.angles, scan.mask)), "cpu",
        rel_sensor_pose=scan.rel_sensor_pose, num_valid=scan.num_valid,
    )
    return jgm, pgm, scan, pscan, true_pose


def test_pyramid_equals_reference(scene):
    jgm, pgm = scene[:2]
    for jarr, parr in ((jgm.prob, pgm.prob), (jgm.observed, pgm.observed)):
        ref = jpool.pyramid(jarr, 4)
        got = pool.pyramid(parr, 4)
        assert len(got) == len(ref) == 5
        for g, r in zip(got, ref):
            assert g.dtype == parr.dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# (nx, ny, stride, map level): the bound sweep over 8-cell blocks of the
# pyramid, one block's fine sweep, and a window above 256 offsets (the
# JAX package's XLA:CPU conv branch).
@pytest.mark.parametrize("shape", [(7, 7, 8, 3), (8, 8, 1, 0), (18, 17, 1, 0)])
def test_sweep_from_hits_bit_for_bit(scene, shape):
    jgm, pgm, scan, pscan, true_pose = scene
    nx, ny, stride, level = shape
    T, crop = 24, 192
    pose = jnp.asarray(true_pose + np.array([0.1, -0.05, 0.02]), jnp.float32)
    step, t0, tmask = jcsm.theta_search_params(scan.ranges, scan.mask, 0.05,
                                               0.3, T)
    off = jnp.asarray(jgm.offset_xy, jnp.float32)
    hr, hc, valid, r0, c0 = jcsm.beam_cells(
        scan.ranges, scan.angles, scan.mask, pose, t0, step, tmask, 0.05, off,
        n_theta=T, crop_rows=crop, crop_cols=crop)
    img = jcsm.build_hit_images(hr, hc, valid, tmask, crop_rows=crop,
                                crop_cols=crop)
    jp = jpool.pyramid(jgm.prob, level)[-1]
    jo = jpool.pyramid(jgm.observed, level)[-1]
    ref_s, ref_k = jcsm.sweep_from_hits(
        img, r0, c0, jp, jo, jnp.int32(-20), jnp.int32(-12),
        nx=nx, ny=ny, stride=stride, precision="split")
    got_s, got_k = csm.sweep_from_hits(
        torch.as_tensor(np.asarray(img.astype(jnp.float32))),
        torch.tensor(int(r0), dtype=torch.int32),
        torch.tensor(int(c0), dtype=torch.int32),
        pool.pyramid(pgm.prob, level)[-1], pool.pyramid(pgm.observed, level)[-1],
        -20, -12, nx=nx, ny=ny, stride=stride, precision="split")
    assert got_s.shape == (T, ny, nx)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))
    assert float(got_s.max()) > 0


def test_sweep_from_hits_raises_on_highest(scene):
    """(Named for the refusal it checked while the port took u8 maps only.)
    ``sweep_from_hits`` on the u8 map at "highest" and on its f32 form at
    "split" and "fast", against the JAX sweep on the same hit images and
    map: known counts equal, scores within 2e-3 (JAX rounds each f32 add,
    the port sums the rounded window exactly and rounds once)."""
    jgm, pgm, scan, pscan, true_pose = scene
    T, crop = 16, 160
    pose = jnp.asarray(true_pose + np.array([0.05, 0.04, -0.01]), jnp.float32)
    step, t0, tmask = jcsm.theta_search_params(scan.ranges, scan.mask, 0.05,
                                               0.2, T)
    off = jnp.asarray(jgm.offset_xy, jnp.float32)
    hr, hc, valid, r0, c0 = jcsm.beam_cells(
        scan.ranges, scan.angles, scan.mask, pose, t0, step, tmask, 0.05, off,
        n_theta=T, crop_rows=crop, crop_cols=crop)
    img = jcsm.build_hit_images(hr, hc, valid, tmask, crop_rows=crop,
                                crop_cols=crop)
    probf = jquant.dequant_prob(jgm.prob)
    for jp, pp, precision in ((jgm.prob, pgm.prob, "highest"),
                              (probf, torch.as_tensor(np.asarray(probf)),
                               "split"),
                              (probf, torch.as_tensor(np.asarray(probf)),
                               "fast")):
        ref_s, ref_k = jcsm.sweep_from_hits(
            img, r0, c0, jp, jgm.observed, jnp.int32(-6), jnp.int32(-5),
            nx=12, ny=11, stride=1, precision=precision)
        got_s, got_k = csm.sweep_from_hits(
            torch.as_tensor(np.asarray(img.astype(jnp.float32))),
            torch.tensor(int(r0), dtype=torch.int32),
            torch.tensor(int(c0), dtype=torch.int32), pp, pgm.observed,
            -6, -5, nx=12, ny=11, stride=1, precision=precision)
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0,
                                   atol=2e-3)
        assert float(got_s.max()) > 1.0


# (config fields, score threshold, known-rate threshold): the test's
# 1 m window, the loop default's 2.5 m window (13 x 13 blocks of 8 at
# node height 6), and the gated-out case where nothing clears 0.99.
CASES = {
    "window_1m": (dict(node_height_max=4, range_x=1.0, range_y=1.0,
                       range_theta=0.3, n_theta_max=64, crop_rows=384,
                       crop_cols=384), 0.2, 0.1),
    "window_2p5m": (dict(n_theta_max=48, crop_rows=320, crop_cols=320),
                    0.3, 0.4),
    "gated_out": (dict(node_height_max=4, range_x=1.0, range_y=1.0,
                       range_theta=0.3, n_theta_max=64, crop_rows=384,
                       crop_cols=384), 0.99, 0.1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_core_same_winner_as_reference(scene, case):
    jgm, pgm, scan, pscan, true_pose = scene
    fields, thr, kthr = CASES[case]
    jcfg = JBranchBoundConfig(**fields)
    cfg = reference.branch_bound_config(jcfg.__dict__)
    init = true_pose + np.array([0.3, -0.3, 0.1])
    h = jcfg.bound_height
    ref = _branch_bound_core(
        jcfg, jgm.prob, jgm.observed,
        jpool.pyramid_jit(jgm.prob, h)[-1], jpool.pyramid_jit(jgm.observed, h)[-1],
        scan.ranges, scan.angles, scan.mask, jnp.asarray(init, jnp.float32),
        jnp.asarray(jgm.offset_xy, jnp.float32), jnp.float32(thr),
        jnp.float32(kthr),
    )
    f0 = host_fetches()
    out, stats = branch_bound.branch_bound_core(
        cfg, pgm.prob, pgm.observed, pool.pyramid(pgm.prob, h)[-1],
        pool.pyramid(pgm.observed, h)[-1], pscan.ranges, pscan.angles,
        pscan.mask, torch.as_tensor(init, dtype=torch.float32),
        torch.as_tensor(np.asarray(jgm.offset_xy), dtype=torch.float32),
        float(np.float32(thr)), float(np.float32(kthr)),
    )
    r_pose, r_score, r_found, r_cost, r_cov = (np.asarray(a) for a in ref)
    pose, score, found, cost, cov = (a.numpy() for a in out)
    assert bool(found) == bool(r_found) == (case != "gated_out")
    np.testing.assert_allclose(pose, r_pose, rtol=0, atol=POSE_TOL)
    assert score == r_score
    np.testing.assert_allclose(cost, r_cost, rtol=COST_RTOL)
    np.testing.assert_allclose(cov, r_cov, rtol=COV_RTOL,
                               atol=COV_RTOL * np.abs(r_cov).max())
    if case == "gated_out":
        # nothing swept clears the gate: offsets default to zero
        np.testing.assert_allclose(pose, init, atol=POSE_TOL)
    else:
        assert 1 <= stats["blocks_swept"] < np.prod(cfg.blocks)
        assert host_fetches() - f0 == stats["blocks_swept"] + 1


def test_matcher_matches_reference_and_caches_pyramid(scene):
    jgm, pgm, scan, pscan, true_pose = scene
    fields = CASES["window_1m"][0]
    init = true_pose + np.array([0.3, -0.3, 0.1])
    jm = JScanMatcherBranchBound(JBranchBoundConfig(**fields))
    pm = branch_bound.ScanMatcherBranchBound(
        branch_bound.BranchBoundConfig(**fields), "cpu")
    pgm.coarse.clear()
    fetched = FetchesOf(pm)
    ref = jm.optimize_pose(ScanMatchingQuery(jgm, scan, init),
                           score_threshold=0.2, known_rate_threshold=0.1)
    got = pm.optimize_pose(PScanMatchingQuery(pgm, pscan, init),
                           score_threshold=0.2, known_rate_threshold=0.1)
    assert got.pose_found and ref.pose_found
    np.testing.assert_allclose(got.estimated_pose, ref.estimated_pose,
                               atol=POSE_TOL)
    assert got.normalized_score == pytest.approx(ref.normalized_score, abs=0)
    assert list(pgm.coarse) == [("pyr", 3)]
    cached = pgm.coarse[("pyr", 3)]
    pm.optimize_pose(PScanMatchingQuery(pgm, pscan, init))
    assert pgm.coarse[("pyr", 3)] is cached
    assert pm.matches == 2
    assert fetched.n == pm.blocks_swept + 2 * pm.matches
