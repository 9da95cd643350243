"""The port's greedy-endpoint cost, grid-search and hill-climbing matchers
against the JAX package's, on u8 maps quantized as the map cache does.

Tolerances, fixed before the first run, and why:
- greedy-endpoint cost: rtol 1e-5 against the JAX cost on the same map,
  u8 or f32 (both gate a u8 map's raw levels, ROADMAP 3.10; the JAX sum is
  f32, the port's an exact f64 sum rounded once); covariance rtol 1e-4 of
  its largest entry (a difference of two such sums over a 0.1 m or 0.02
  rad step, squared);
- grid search, integer steps: the sweep's score and known grids bitwise
  equal to JAX's ``csm_sweep`` on the same beam cells (exact integer sums
  on both sides); the port's own beam cells differ from the JAX package's
  in at most 0.5 % of (theta, beam) pairs (last-ulp trig, ROADMAP 1.1);
  the whole matcher: the same ``pose_found``, the pose within one search
  step, the score within 2 / n (two beams' cells moved by such an ulp);
- grid search, arbitrary steps: the same, the port summing u8 levels
  exactly where JAX sums f32 probabilities (a further 1e-5);
- per-candidate scores against ``utils/oracle.py`` (f64 NumPy cells):
  abs 1e-6;
- hill climbing: greedy-endpoint costs tie exactly, and the JAX package's
  f32 sums may break a tie by an ulp either way, after which the climb
  takes another move; at most 1 of the 16 queries per cost may end
  elsewhere, the others within 1e-6 (m, rad).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.matching import grid_search as jgs
from my_lidar_graph_slam_v2_tpu.matching import hill_climbing as jhc
from my_lidar_graph_slam_v2_tpu.matching.cost import CostConfig as JCostConfig
from my_lidar_graph_slam_v2_tpu.matching.cost import covariance_at as jcovariance_at
from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster, ScanMatchingQuery
from my_lidar_graph_slam_v2_tpu.ops import csm as jcsm
from my_lidar_graph_slam_v2_tpu.ops import greedy_endpoint as jge
from my_lidar_graph_slam_v2_tpu.ops import quant as jquant
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.grid.geometry import GridGeometry
from my_lidar_graph_slam_v2_tpu_torch.matching import cost as pcost
from my_lidar_graph_slam_v2_tpu_torch.matching import grid_search as pgs
from my_lidar_graph_slam_v2_tpu_torch.matching import hill_climbing as phc
from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
    ScanMatchingQuery as PScanMatchingQuery,
)
from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda, greedy_endpoint
from my_lidar_graph_slam_v2_tpu_torch.utils import oracle
from torch_counters import FetchesOf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from tests.test_matchers import RES, build_map, make_scan_arrays

COST_RTOL = 1e-5
COV_RTOL = 1e-4
CELL_FLIP_FRACTION = 5e-3
ORACLE_ATOL = 1e-6
HILL_MISSES = 1
HILL_TOL = 1e-6
TRUE = np.array([0.35, -0.25, 0.12])
# A raster offset off the 5 cm grid: the synthetic room's walls at +-3 m
# would otherwise fall on cell boundaries, where any ulp moves a cell.
OFF = -8.0123


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """A u8 map of the synthetic room seen from two poses, as the map
    cache quantizes it, and a scan from the true
    pose, for both packages."""
    rng = np.random.default_rng(21)
    gm, _ = build_map([np.zeros(3)] * 16 + [TRUE] * 16, rng=rng, off=OFF)
    prob = np.asarray(jquant.quantize_prob_f32(gm.prob))
    obs = np.asarray(gm.observed)
    scan = make_scan_arrays(TRUE, rng=rng)
    return dict(
        prob=prob, obs=obs,
        offset_xy=gm.offset_xy, scan=scan,
        pmap=reference.map_raster(prob, obs, gm.offset_xy, RES, "cpu"),
        pscan=reference.scan_arrays(
            *(np.asarray(a) for a in (scan.ranges, scan.angles, scan.mask)),
            "cpu", rel_sensor_pose=scan.rel_sensor_pose,
            num_valid=scan.num_valid),
    )


def _jmap(scene):
    return MapRaster(jnp.asarray(scene["prob"]), jnp.asarray(scene["obs"]),
                     RES, scene["offset_xy"])


def _random_case(seed, H=128, W=128, B=64):
    rng = np.random.default_rng(seed)
    return dict(
        prob=rng.integers(0, 256, (H, W)).astype(np.uint8),
        obs=rng.uniform(size=(H, W)) < 0.7,
        ranges=rng.uniform(0.5, 2.5, B).astype(np.float32),
        angles=np.linspace(-3, 3, B).astype(np.float32),
        mask=rng.uniform(size=B) < 0.9,
        poses=(np.array([3.2, 3.1, 0.3])
               + rng.normal(0, 0.1, (6, 3))).astype(np.float32),
        off=np.array([0.013, -0.021], np.float32),
    )


def _scene_case(scene):
    s = scene["scan"]
    rng = np.random.default_rng(4)
    return dict(
        prob=scene["prob"], obs=scene["obs"],
        ranges=np.asarray(s.ranges), angles=np.asarray(s.angles),
        mask=np.asarray(s.mask),
        poses=(TRUE + rng.normal(0, 0.05, (6, 3))).astype(np.float32),
        off=np.asarray(scene["offset_xy"], np.float32),
    )


def _jax_costs(c, prob, kernel_size):
    kx, ky, kc, kd = jge.make_kernel_tables(kernel_size, RES, 0.05)
    return np.array([float(jge.cost(
        jnp.asarray(prob), jnp.asarray(c["obs"]), jnp.asarray(c["ranges"]),
        jnp.asarray(c["angles"]), jnp.asarray(c["mask"]), jnp.asarray(p),
        RES, jnp.asarray(c["off"]), kernel_ox=kx, kernel_oy=ky,
        kernel_cost=kc, default_cost=kd)) for p in c["poses"]])


def _port_costs(c, prob, kernel_size):
    ccfg = pcost.CostConfig(cost_type="GreedyEndpoint", kernel_size=kernel_size)
    return pcost.cost_at(ccfg, t(prob), t(c["obs"]), t(c["ranges"]),
                         t(c["angles"]), t(c["mask"]), t(c["poses"]), RES,
                         t(c["off"]))


# ---- greedy endpoint ------------------------------------------------------
@pytest.mark.parametrize("kernel_size", [1, 2])
@pytest.mark.parametrize("case", ["random", "scene"])
def test_greedy_endpoint_u8_equals_reference_on_dequantized_map(
        scene, case, kernel_size):
    """The port's cost on a u8 map equals the JAX cost on the same u8
    map (both gate its raw levels, ROADMAP 3.10; the name is older than
    that repair); six poses in one call equal six single calls bit for
    bit, and the covariance follows within its tolerance."""
    c = _random_case(0) if case == "random" else _scene_case(scene)
    got = _port_costs(c, c["prob"], kernel_size)
    np.testing.assert_allclose(got.numpy(),
                               _jax_costs(c, c["prob"], kernel_size),
                               rtol=COST_RTOL)
    ccfg = pcost.CostConfig(cost_type="GreedyEndpoint", kernel_size=kernel_size)
    args = [t(c[k]) for k in ("prob", "obs", "ranges", "angles", "mask")]
    for i, p in enumerate(c["poses"]):
        one = pcost.cost_at(ccfg, *args, t(p), RES, t(c["off"]))
        assert torch.equal(one, got[i])
    jccfg = JCostConfig(cost_type="GreedyEndpoint", kernel_size=kernel_size)
    jargs = [jnp.asarray(a) for a in (c["prob"], c["obs"], c["ranges"],
                                      c["angles"], c["mask"])]
    for p in c["poses"][:2]:
        jcov = np.asarray(jcovariance_at(jccfg, *jargs, jnp.asarray(p), RES,
                                         jnp.asarray(c["off"])))
        pcov = pcost.covariance_at(ccfg, *args, t(p), RES, t(c["off"])).numpy()
        np.testing.assert_allclose(pcov, jcov, rtol=0,
                                   atol=COV_RTOL * np.abs(jcov).max())


def test_greedy_endpoint_f32_equals_reference():
    """On an f32 probability map both packages compute the same cost, and
    it differs from the cost on the map's u8 form, whose gate reads
    levels."""
    c = _random_case(1)
    probf = np.asarray(jquant.dequant_prob(c["prob"]))
    on_f32 = _port_costs(c, probf, 1)
    np.testing.assert_allclose(on_f32.numpy(), _jax_costs(c, probf, 1),
                               rtol=COST_RTOL)
    assert torch.all((on_f32 - _port_costs(c, c["prob"], 1)).abs() > 1.0)


def test_reference_greedy_endpoint_gates_u8_levels():
    """ROADMAP 3.9 / 3.10: the JAX cost compares raw u8 levels with the
    occupancy threshold 0.1, so on a u8 map every non-zero level is
    "occupied" and only level 0 is "free"; its value differs from the same
    map's probabilities.  The port gates the same way: its u8 cost equals
    the JAX u8 cost, its f32 cost the JAX f32 cost."""
    c = _random_case(0)
    probf = np.asarray(jquant.dequant_prob(c["prob"]))
    j_u8, j_f32 = _jax_costs(c, c["prob"], 1), _jax_costs(c, probf, 1)
    assert np.all(np.abs(j_u8 - j_f32) > 1.0), (j_u8, j_f32)
    np.testing.assert_allclose(_port_costs(c, c["prob"], 1).numpy(), j_u8,
                               rtol=COST_RTOL)
    np.testing.assert_allclose(_port_costs(c, probf, 1).numpy(), j_f32,
                               rtol=COST_RTOL)


def test_greedy_endpoint_tables_equal_reference():
    for k in (1, 2, 3):
        j = jge.make_kernel_tables(k, RES, 0.05)
        p = greedy_endpoint.make_kernel_tables(k, RES, 0.05, "cpu")
        for a, b in zip(j, p):
            assert np.array_equal(np.asarray(a), b.numpy())
            assert np.asarray(a).dtype == b.numpy().dtype


# ---- grid search ----------------------------------------------------------
GS_INT = dict(range_x=1.0, range_y=1.0, range_theta=0.3, step_theta=0.01,
              crop_rows=384, crop_cols=384)
GS_ARB = dict(range_x=0.5, range_y=0.5, range_theta=0.2, step_x=0.025,
              step_y=0.025, step_theta=0.02, crop_rows=384, crop_cols=384)
INIT = TRUE + np.array([0.3, -0.3, 0.1])


def test_grid_search_sweep_equals_reference_bitwise(scene):
    """Integer steps at n_off > 256 (JAX's CPU conv branch): given the JAX
    package's beam cells, the port's single sweep gives JAX's score and
    known grids bit for bit; the port's own cells differ in few pairs."""
    cfg = jgs.GridSearchConfig(**GS_INT)
    wx, wy, wt = cfg.wins
    T, nx, ny = 2 * wt + 1, 2 * wx + 1, 2 * wy + 1
    assert nx * ny > 256
    s = scene["scan"]
    sp = jnp.asarray(INIT, jnp.float32)
    off = jnp.asarray(scene["offset_xy"], jnp.float32)
    cells = (s.ranges, s.angles, s.mask, sp, jnp.int32(-wt),
             jnp.float32(cfg.step_theta), jnp.ones(T, bool), RES, off)
    ckw = dict(n_theta=T, crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols)
    j_scores, j_known = jcsm.csm_sweep(
        jnp.asarray(scene["prob"]), jnp.asarray(scene["obs"]), *cells[:7],
        jnp.int32(-wx), jnp.int32(-wy), RES, off, nx=nx, ny=ny, stride=1,
        precision=cfg.precision, **ckw)
    hr, hc, valid, r0, c0 = (t(a) for a in jcsm.beam_cells(*cells, **ckw))
    win = csm.sweep_input_window(t(scene["prob"]), t(scene["obs"]), r0, c0,
                                 -wx, -wy, in_rows=cfg.crop_rows + ny - 1,
                                 in_cols=cfg.crop_cols + nx - 1)
    launches = csm_cuda.LAUNCHES
    out = csm.sweep(win[None].contiguous(), hr[None], hc[None], valid[None],
                    torch.zeros((1, 1, 2), dtype=torch.int32),
                    tile_h=ny, tile_w=nx, stride=1)[0]
    assert csm_cuda.LAUNCHES == launches  # CPU tensors: the plain version
    assert np.array_equal(out[:, 0].reshape(T, ny, nx).numpy(),
                          np.asarray(j_scores))
    assert np.array_equal(out[:, 1].reshape(T, ny, nx).numpy(),
                          np.asarray(j_known))
    ph, pc, pv, pr0, pc0 = csm.beam_cells(
        *(t(a) for a in (s.ranges, s.angles, s.mask)), t(sp),
        torch.tensor(-wt, dtype=torch.int32),
        torch.tensor(cfg.step_theta, dtype=torch.float32),
        torch.ones(T, dtype=torch.bool), RES, t(off), **ckw)
    assert (int(pr0), int(pc0)) == (int(r0), int(c0))
    flips = int(((ph != hr) | (pc != hc)).sum())
    assert flips <= CELL_FLIP_FRACTION * hr.numel(), flips
    # the port's scores from its own cells, through the matcher's path
    ps, pk = pgs.sweep_scores(
        reference.grid_search_config(dataclasses.asdict(cfg)),
        t(scene["prob"]), t(scene["obs"]),
        *(t(a) for a in (s.ranges, s.angles, s.mask)), t(sp), t(off))
    if flips == 0:
        assert np.array_equal(ps.numpy(), np.asarray(j_scores))
        assert np.array_equal(pk.numpy(), np.asarray(j_known))


def _run_grid_search(scene, kw, cost, init, thresholds=(0.3, 0.5)):
    jcfg = jgs.GridSearchConfig(
        **kw, cost=None if cost is None else JCostConfig(cost_type=cost))
    js = jgs.ScanMatcherGridSearch(jcfg).optimize_pose(
        ScanMatchingQuery(_jmap(scene), scene["scan"], init), *thresholds)
    pm = pgs.ScanMatcherGridSearch(
        reference.grid_search_config(dataclasses.asdict(jcfg)), "cpu")
    fetched = FetchesOf(pm)
    ps = pm.optimize_pose(
        PScanMatchingQuery(scene["pmap"], scene["pscan"], init), *thresholds)
    assert pm.matches == fetched.n == 1
    return jcfg, js, ps


def _assert_grid_search_match(scene, jcfg, js, ps, score_atol):
    n = scene["scan"].num_valid
    assert ps.pose_found == js.pose_found
    steps = np.array([jcfg.step_x, jcfg.step_y, jcfg.step_theta])
    assert np.all(np.abs(ps.estimated_pose - js.estimated_pose)
                  <= steps + 1e-6), (ps.estimated_pose, js.estimated_pose)
    if ps.pose_found:
        assert abs(ps.normalized_score - js.normalized_score) <= \
            2.0 / n + score_atol


@pytest.mark.parametrize("cost", [None, "GreedyEndpoint"])
def test_grid_search_matcher_matches_reference(scene, cost):
    """Integer steps: the whole matcher within one step and 2 / n of
    score.  The winner's cost: SquareError within rtol 1e-3 of JAX's; the
    port's GreedyEndpoint cost equals the JAX cost on the same u8 map at
    the port's winner, both winners are one pose (within 1e-6), and the
    JAX matcher's own winner cost equals the port's."""
    jcfg, js, ps = _run_grid_search(scene, GS_INT, cost, INIT)
    assert ps.pose_found
    assert np.abs(ps.estimated_pose - TRUE)[:2].max() <= 1.5 * RES
    _assert_grid_search_match(scene, jcfg, js, ps, 0.0)
    n = scene["scan"].num_valid
    if cost is None:
        np.testing.assert_allclose(ps.normalized_cost, js.normalized_cost,
                                   rtol=1e-3)
        np.testing.assert_allclose(ps.covariance, js.covariance, rtol=0,
                                   atol=1e-3 * np.abs(js.covariance).max())
        return
    kx, ky, kc, kd = jge.make_kernel_tables(1, RES, 0.05)
    s = scene["scan"]
    want = float(jge.cost(
        jnp.asarray(scene["prob"]), jnp.asarray(scene["obs"]), s.ranges,
        s.angles, s.mask, jnp.asarray(ps.estimated_pose, jnp.float32), RES,
        jnp.asarray(scene["offset_xy"], jnp.float32), kernel_ox=kx,
        kernel_oy=ky, kernel_cost=kc, default_cost=kd)) / n
    np.testing.assert_allclose(ps.normalized_cost, want, rtol=COST_RTOL)
    # Both matchers score this scene's beam cells alike, so they pick one
    # winner and the JAX matcher's own winner cost is the port's.
    np.testing.assert_allclose(ps.estimated_pose, js.estimated_pose,
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(ps.normalized_cost, js.normalized_cost,
                               rtol=COST_RTOL)


@pytest.mark.parametrize("init", [TRUE + np.array([0.1, -0.08, 0.04]),
                                  TRUE + np.array([-0.12, 0.05, -0.06])])
def test_grid_search_arbitrary_steps_match_reference(scene, init):
    """Steps of half a cell: the gather core, within one step and 2 / n
    (+ 1e-5) of score."""
    jcfg, js, ps = _run_grid_search(scene, GS_ARB, None, init)
    assert not jcfg.integer_steps and ps.pose_found
    _assert_grid_search_match(scene, jcfg, js, ps, 1e-5)
    assert np.linalg.norm(ps.estimated_pose[:2] - TRUE[:2]) < 0.08


@pytest.mark.parametrize("step", [RES, 0.03])
def test_grid_search_scores_equal_the_oracle(step):
    """Every candidate's (score, known) of a small window against
    ``score_pixel_accurate_oracle`` on the port's ``GridGeometry``, cells
    from f64 NumPy: the sweep (step = resolution) and the gather core."""
    rng = np.random.default_rng(8)
    H, W, B = 160, 150, 48
    geom = GridGeometry(RES, H, W, -4.0 + 0.0137, -4.0 - 0.0071)
    obs = rng.uniform(size=(H, W)) < 0.8
    prob = np.where(obs, rng.integers(1, 256, (H, W)), 0).astype(np.uint8)
    ranges = rng.uniform(0.4, 3.0, B).astype(np.float32)
    angles = np.sort(rng.uniform(-np.pi, np.pi, B)).astype(np.float32)
    mask = rng.uniform(size=B) < 0.9
    pose = np.array([0.11, -0.07, 0.25], np.float32)
    cfg = pgs.GridSearchConfig(range_x=4 * step, range_y=4 * step,
                               range_theta=0.04, step_x=step, step_y=step,
                               step_theta=0.01, resolution=RES,
                               crop_rows=140, crop_cols=140)
    wx, wy, wt = cfg.wins
    off = np.array([geom.offset_x, geom.offset_y], np.float32)
    core = pgs.sweep_scores if cfg.integer_steps else pgs.pixel_scores_gather
    scores, known = core(cfg, t(prob), t(obs), t(ranges), t(angles), t(mask),
                         t(pose), t(off))
    probf = prob.astype(np.float64) / 255.0
    r, a = ranges[mask].astype(np.float64), angles[mask].astype(np.float64)
    n = int(mask.sum())
    for ti in range(2 * wt + 1):
        th = float(pose[2]) + (ti - wt) * cfg.step_theta
        for j in range(2 * wy + 1):
            for i in range(2 * wx + 1):
                x = float(pose[0]) + (i - wx) * step + r * np.cos(th + a)
                y = float(pose[1]) + (j - wy) * step + r * np.sin(th + a)
                rows, cols = geom.position_to_index(x, y)
                s, k = oracle.score_pixel_accurate_oracle(probf, rows, cols, n)
                assert abs(float(scores[ti, j, i]) / n - s) <= ORACLE_ATOL
                assert abs(float(known[ti, j, i]) / n - k) <= ORACLE_ATOL


def test_grid_search_refuses_f32_maps_and_highest(scene):
    """(Named for the refusal it checked while the port took u8 maps only.)
    The matcher on the scene's f32 probabilities (the u8 map dequantized)
    at "split", and on the u8 map at "highest", against the JAX matcher on
    the same map: integer and arbitrary steps, the tolerances of the u8
    matches plus 2e-3 / n of score (JAX rounds each f32 add, the port sums
    exactly and rounds once)."""
    n = scene["scan"].num_valid
    probf = np.asarray(jquant.dequant_prob(scene["prob"]))
    f32_scene = dict(scene, prob=probf, pmap=reference.map_raster(
        probf, scene["obs"], scene["offset_xy"], RES, "cpu"))
    assert f32_scene["pmap"].prob.dtype == torch.float32
    near = TRUE + np.array([0.1, -0.08, 0.04])
    for sc, kw, init in ((f32_scene, GS_INT, INIT), (f32_scene, GS_ARB, near),
                         (scene, dict(GS_INT, precision="highest"), INIT)):
        jcfg, js, ps = _run_grid_search(sc, kw, None, init)
        assert ps.pose_found
        _assert_grid_search_match(sc, jcfg, js, ps, 2e-3 / n)
        assert np.linalg.norm(ps.estimated_pose[:2] - TRUE[:2]) < 0.08


def test_grid_search_config_properties_equal_reference():
    for kw in (GS_INT, GS_ARB, {}, dict(step_x=0.05 + 1e-10)):
        j = jgs.GridSearchConfig(**kw)
        p = pgs.GridSearchConfig(**kw)
        assert (p.integer_steps, p.wins) == (j.integer_steps, j.wins)


# ---- hill climbing --------------------------------------------------------
@pytest.mark.parametrize("cost", ["GreedyEndpoint", "SquareError"])
def test_hill_climbing_matches_reference(scene, cost):
    """16 seeded starts, both climbers on the same u8 map.  One fetch per
    iteration, plus the start cost and the covariance."""
    jcfg = jhc.HillClimbingConfig(cost=JCostConfig(cost_type=cost))
    jm = jhc.ScanMatcherHillClimbing(jcfg)
    pm = phc.ScanMatcherHillClimbing(
        reference.hill_climbing_config(dataclasses.asdict(jcfg)), "cpu")
    jmap = _jmap(scene)
    fetched = FetchesOf(pm)
    rng = np.random.default_rng(12)
    misses = 0
    for _ in range(16):
        init = TRUE + rng.normal(0, [0.08, 0.08, 0.04])
        js = jm.optimize_pose(ScanMatchingQuery(jmap, scene["scan"], init))
        ps = pm.optimize_pose(
            PScanMatchingQuery(scene["pmap"], scene["pscan"], init))
        if np.abs(ps.estimated_pose - js.estimated_pose).max() > HILL_TOL:
            misses += 1
            continue
        np.testing.assert_allclose(ps.normalized_cost, js.normalized_cost,
                                   rtol=COST_RTOL)
        np.testing.assert_allclose(ps.covariance, js.covariance, rtol=0,
                                   atol=COV_RTOL * np.abs(js.covariance).max())
    assert misses <= HILL_MISSES, misses
    assert fetched.n == pm.iterations + 2 * pm.matches
    assert pm.matches == 16 and pm.iterations >= 16
