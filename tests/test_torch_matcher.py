"""Parity of the port's matchers with the JAX package's: the fused
frontend match (``_fused_core_deltas``) on the same fold inputs, and the
unfused correlative + GN pair on the same raster.

The fold inputs (per-scan delta images + shifts) and the scan come from a
JAX frontend run over a synthetic office world; both packages get them as
NumPy arrays.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.datasets import synthetic
from my_lidar_graph_slam_v2_tpu.matching.correlative import (
    CorrelativeConfig as JCorrelativeConfig,
    ScanMatcherCorrelative,
)
from my_lidar_graph_slam_v2_tpu.matching.linear_solver import (
    LinearSolverConfig as JLinearSolverConfig,
    ScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu.matching.types import (
    MapRaster,
    ScanArrays,
    ScanMatchingQuery,
)
from my_lidar_graph_slam_v2_tpu.metrics.registry import (
    MetricManager as JMetricManager,
)
from my_lidar_graph_slam_v2_tpu.models import fused_matcher as jfm
from my_lidar_graph_slam_v2_tpu.ops import quant as jquant
from my_lidar_graph_slam_v2_tpu.pipeline.factory import create_default_slam
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.core import pose as P
from my_lidar_graph_slam_v2_tpu_torch.matching import correlative as pcor
from my_lidar_graph_slam_v2_tpu_torch.matching import linear_solver as plin
from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
    ScanMatchingQuery as PScanMatchingQuery,
)
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
    MetricManager as PMetricManager,
)
from my_lidar_graph_slam_v2_tpu_torch.models import fused_matcher as pfm
from my_lidar_graph_slam_v2_tpu_torch.utils.transfer import fetch, to_device
from torch_counters import host_fetches
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = dict(map_rows=384, map_cols=384, samples_per_beam=320,
             usable_range_max=8.0, n_theta_max=96, crop=320)


@pytest.fixture(scope="module")
def case():
    """Fold inputs + the next keyframe's scan, from a JAX frontend run."""
    world = synthetic.World.office(seed=3, size=10.0)
    traj = synthetic.loop_trajectory(size=10.0, laps=0.12, step=0.08)
    seq = synthetic.generate(world, traj, n_beams=181, max_range=10.0,
                             range_noise=0.01, odom_noise=(0.03, 0.01), seed=4)
    slam = create_default_slam(**SIZES)
    for scan in seq.scans[:-1]:
        slam.process_scan(scan, scan.odom_pose)
    last = seq.scans[-1]
    _, fold, map_pose = slam.get_latest_match_data()
    fe = slam.frontend
    scan = fe.interpolator.interpolate(fe.outlier_filter.remove_outliers(last))
    sa = fe._scan_arrays(scan)
    guess = P.compound(slam.pose_graph.scan_nodes[-1].global_pose,
                       P.inverse_compound(fe.last_map_update_odom_pose,
                                          last.odom_pose))
    init = P.inverse_compound(map_pose, guess)
    sensor_pose = P.compound(init, sa.rel_sensor_pose).astype(np.float32)
    return dict(
        deltas=[np.asarray(d) for d in fold["deltas"]],
        shifts=np.asarray(fold["shifts"]), valid=np.asarray(fold["valid"]),
        offset_xy=np.asarray(fold["offset_xy"]), max_shift=fold["max_shift"],
        ranges=np.asarray(sa.ranges), angles=np.asarray(sa.angles),
        mask=np.asarray(sa.mask), sensor_pose=sensor_pose, init=init,
        ccfg=slam.frontend.scan_matcher.ccfg, lcfg=slam.frontend.scan_matcher.lcfg,
    )


def _run_both(case, ccfg, dense=False, ranges=None, angles=None, mask=None):
    ranges = case["ranges"] if ranges is None else ranges
    angles = case["angles"] if angles is None else angles
    mask = case["mask"] if mask is None else mask
    lcfg = case["lcfg"]
    j = jax.device_get(jfm._fused_core_deltas(
        ccfg, lcfg, tuple(jnp.asarray(d) for d in case["deltas"]),
        jnp.asarray(case["shifts"]), jnp.asarray(case["valid"]),
        jnp.asarray(ranges), jnp.asarray(angles), jnp.asarray(mask),
        jnp.asarray(case["sensor_pose"]),
        jnp.asarray(case["offset_xy"], jnp.float32),
        jnp.float32(0.0), jnp.float32(0.0),
        max_shift=case["max_shift"], dense=dense,
    ))
    fold = reference.fold_inputs(case["deltas"], case["shifts"], case["valid"],
                                 case["offset_xy"], case["max_shift"], "cpu")
    p = fetch(pfm.fused_core_deltas(
        reference.correlative_config(dataclasses.asdict(ccfg)),
        reference.linear_solver_config(dataclasses.asdict(lcfg)),
        fold["deltas"], fold["shifts"], fold["valid"],
        to_device(ranges, "cpu"), to_device(angles, "cpu"), to_device(mask, "cpu"),
        to_device(case["sensor_pose"], "cpu"),
        to_device(case["offset_xy"], "cpu", np.float32), 0.0, 0.0,
        max_shift=fold["max_shift"], dense=dense,
    ))
    return [np.asarray(x, np.float64) for x in j], p


# Tolerances.  The fold adds and clips the same f32 values in the same
# order (exact); the u8 quantization may move a level by one where torch's
# and XLA's sigmoid differ in the last ulp, so score and known (sums of
# levels / 255 / n) may differ by a few 1/(255 n).  The pose after GN
# refinement and the costs are f32 reductions in another order: 1e-4 m /
# rad (a 500th of a cell) and rtol 1e-3.  Integers (counts, iterations,
# flags) must be equal.
def _assert_match(j, p, n):
    (refined, cov, score, known, found, ncost, iters, n_proc, n_total,
     csm_pose, csm_ncost, exact) = range(12)
    np.testing.assert_allclose(p[csm_pose], j[csm_pose], atol=1e-4)
    np.testing.assert_allclose(p[refined], j[refined], atol=1e-4)
    for k in (score, known):
        assert abs(p[k] - j[k]) <= 3.0 / (255.0 * n), (k, p[k], j[k])
    for k in (ncost, csm_ncost):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(p[cov], j[cov], rtol=1e-3,
                               atol=1e-3 * np.abs(j[cov]).max())
    for k in (found, iters, n_proc, n_total, exact):
        assert p[k] == j[k], (k, p[k], j[k])


def test_fused_core_matches(case):
    j, p = _run_both(case, case["ccfg"])
    _assert_match(j, p, case["mask"].sum())
    assert j[-1] == 1.0  # the certified top-K prune held


def test_fused_core_dense_rerun_matches(case):
    j, p = _run_both(case, case["ccfg"], dense=True)
    _assert_match(j, p, case["mask"].sum())


def test_exact_flag_and_dense_fallback(case):
    """A degenerate scan (200 beams on one endpoint, > 127 per cell) fails
    the int8 certificate in both packages: ``exact`` is false and the
    matcher re-runs densely, as the JAX matcher does."""
    ranges, angles = case["ranges"].copy(), case["angles"].copy()
    ranges[:200], angles[:200] = ranges[0], angles[0]
    j, p = _run_both(case, case["ccfg"], ranges=ranges, angles=angles)
    assert j[-1] == 0.0 and p[-1] == 0.0

    lcfg = case["lcfg"]
    jm = jfm.FusedCorrelativeGNMatcher(case["ccfg"], lcfg, name="TorchParity.J")
    pm = pfm.FusedCorrelativeGNMatcher(
        reference.correlative_config(dataclasses.asdict(case["ccfg"])),
        reference.linear_solver_config(dataclasses.asdict(lcfg)), "cpu",
        name="TorchParity.P",
    )
    jfold = dict(deltas=tuple(jnp.asarray(d) for d in case["deltas"]),
                 shifts=jnp.asarray(case["shifts"]),
                 valid=jnp.asarray(case["valid"]),
                 offset_xy=case["offset_xy"], max_shift=case["max_shift"])
    pfold = reference.fold_inputs(case["deltas"], case["shifts"], case["valid"],
                                  case["offset_xy"], case["max_shift"], "cpu")
    n = int(case["mask"].sum())
    meta = dict(rel_sensor_pose=np.zeros(3), num_valid=n,
                max_range=float(ranges[case["mask"]].max()))
    js = jm.optimize_pose_deltas(jfold, ScanArrays(
        jnp.asarray(ranges), jnp.asarray(angles), jnp.asarray(case["mask"]),
        **meta), case["init"])
    f0 = host_fetches()
    ps = pm.optimize_pose_deltas(pfold, reference.scan_arrays(
        ranges, angles, case["mask"], "cpu", **meta), case["init"])
    fetched = host_fetches() - f0
    jcount = JMetricManager.instance().counter("TorchParity.J.DenseFallbacks")
    pcount = PMetricManager.instance().counter("TorchParity.P.DenseFallbacks")
    assert jcount.value == 1 and pcount.value == 1
    assert fetched == 2
    np.testing.assert_allclose(ps.estimated_pose, js.estimated_pose, atol=1e-4)
    assert ps.pose_found == js.pose_found


def test_two_stage_matchers_on_a_raster():
    """The unfused pair (correlative search with cached full-map coarse
    maps, then the GN matcher) on one u8 raster handed to both packages
    through ``reference.map_raster``.  Tolerances as above."""
    from tests.test_matchers import build_map, make_scan_arrays

    rng = np.random.default_rng(31)
    true = np.array([0.3, -0.2, 0.1])
    gm, _ = build_map([np.zeros(3)] * 8 + [true] * 8, rng=rng)
    prob = np.asarray(jquant.quantize_prob_f32(gm.prob))
    obs = np.asarray(gm.observed)
    scan = make_scan_arrays(true)
    init = true + np.array([0.05, -0.06, 0.08])
    jcfg = JCorrelativeConfig(crop_rows=320, crop_cols=320, n_theta_max=96)
    j_map = MapRaster(jnp.asarray(prob), jnp.asarray(obs), gm.resolution,
                      gm.offset_xy)
    p_map = reference.map_raster(prob, obs, gm.offset_xy, gm.resolution, "cpu")
    p_scan = reference.scan_arrays(
        *(np.asarray(a) for a in (scan.ranges, scan.angles, scan.mask)),
        "cpu", rel_sensor_pose=scan.rel_sensor_pose, num_valid=scan.num_valid)

    js = ScanMatcherCorrelative(jcfg, "TorchParity.JC").optimize_pose(
        ScanMatchingQuery(j_map, scan, init))
    ps = pcor.ScanMatcherCorrelative(
        reference.correlative_config(dataclasses.asdict(jcfg)), "cpu",
        "TorchParity.PC").optimize_pose(PScanMatchingQuery(p_map, p_scan, init))
    assert js.pose_found and ps.pose_found
    np.testing.assert_allclose(ps.estimated_pose, js.estimated_pose, atol=1e-4)
    n = scan.num_valid
    assert abs(ps.normalized_score - js.normalized_score) <= 3.0 / (255.0 * n)
    assert abs(ps.known_rate - js.known_rate) <= 3.0 / (255.0 * n)

    lcfg = JLinearSolverConfig()
    jf = ScanMatcherLinearSolver(lcfg, "TorchParity.JL").optimize_pose(
        ScanMatchingQuery(j_map, scan, js.estimated_pose))
    pf = plin.ScanMatcherLinearSolver(
        reference.linear_solver_config(dataclasses.asdict(lcfg)), "cpu",
        "TorchParity.PL").optimize_pose(
            PScanMatchingQuery(p_map, p_scan, ps.estimated_pose))
    np.testing.assert_allclose(pf.estimated_pose, jf.estimated_pose, atol=1e-4)
    np.testing.assert_allclose(pf.covariance, jf.covariance, rtol=1e-3,
                               atol=1e-3 * np.abs(jf.covariance).max())
    assert np.abs(pf.estimated_pose - true).max() < 0.02
