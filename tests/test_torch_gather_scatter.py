"""The gather sweep backend and the scatter rasterizer of the port against
the JAX package's, on the CPU.

Tolerances, fixed before the first run, and why:
- ``sweep_windows`` on the same map cells: u8 maps equal bit for bit
  (integer sums times f32(1/255) on both sides); f32 maps known equal and
  scores within 2e-3 (JAX rounds each f32 add, the port rounds once);
- the correlative core with ``sweep_backend="gather"``: the same found and
  exact flags, poses within 1e-4 m / rad (the same cell), scores within
  (2 + 2e-3) / n (two beams' cells on either side of an edge under the
  two packages' f32 trig);
- ``scan_delta`` and ``integrate_scans``: equal bit for bit wherever the
  two packages' sample cells agree.  Samples are ``floor(f32 / res)``,
  and only a sample within 2e-4 cells of a cell edge (computed in f64;
  the f32 arithmetic errs by a few ulps, ~1e-5 cells at 6 m) can land in
  another cell; the cells around such samples are left out, and
  everything else, the cells many beams end in included, must be equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.matching import correlative as jcor
from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster, ScanMatchingQuery
from my_lidar_graph_slam_v2_tpu.ops import csm as jcsm
from my_lidar_graph_slam_v2_tpu.ops import quant as jquant
from my_lidar_graph_slam_v2_tpu.ops import rasterize as jras
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.grid.builder import GridMapBuilderConfig
from my_lidar_graph_slam_v2_tpu_torch.matching import correlative as pcor
from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
    ScanMatchingQuery as PScanMatchingQuery,
)
from my_lidar_graph_slam_v2_tpu_torch.ops import csm, rasterize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from tests.test_matchers import RES, build_map, make_scan_arrays

SCORE_ATOL = 2e-3
POSE_TOL = 1e-4
LH = float(np.log(0.62 / 0.38))
LM = float(np.log(0.46 / 0.54))


def t(a):
    return torch.as_tensor(np.array(a))


# ---- the gather sweep -----------------------------------------------------
def _cells(seed, T=10, B=70, H=90, W=80):
    """Map cells of T x B beams spread over an H x W map and beyond it on
    every side, about 10 % masked."""
    rng = np.random.default_rng(seed)
    row = rng.integers(-12, H + 12, (T, B)).astype(np.int32)
    col = rng.integers(-12, W + 12, (T, B)).astype(np.int32)
    ok = rng.uniform(size=(T, B)) < 0.9
    obs = rng.uniform(size=(H, W)) < 0.7
    levels = np.where(obs, rng.integers(1, 256, (H, W)), 0).astype(np.uint8)
    probf = np.where(obs, rng.uniform(1e-3, 1 - 1e-3, (H, W)), 0)
    return row, col, ok, obs, levels, probf.astype(np.float32)


@pytest.mark.parametrize("ny,nx,stride,y0,x0", [(7, 6, 1, -3, -4),
                                                (3, 4, 5, -8, -2)])
def test_sweep_windows_equals_reference(ny, nx, stride, y0, x0):
    """Beams off the map read unknown in both (the JAX package's zero pad,
    the port's off-window cells), as JAX ``tests/test_csm.py:201``."""
    row, col, ok, obs, levels, probf = _cells(50 + stride)
    row[:, 0], col[:, 1] = -30, 500  # far off the map
    for prob in (levels, probf):
        ref = jcsm.sweep_windows(jnp.asarray(prob), jnp.asarray(obs),
                                 jnp.asarray(row), jnp.asarray(col),
                                 jnp.asarray(ok), jnp.int32(y0),
                                 jnp.int32(x0), ny=ny, nx=nx, stride=stride)
        got = csm.sweep_windows(t(prob), t(obs), t(row), t(col), t(ok), y0,
                                x0, ny=ny, nx=nx, stride=stride)
        assert got[0].shape == (row.shape[0], ny, nx)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        if prob.dtype == np.uint8:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        else:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                       rtol=0, atol=SCORE_ATOL)
        assert float(got[1].max()) > 10


def test_sweep_windows_batch_on_a_map_stack_equals_single_calls():
    row, col, ok, obs, levels, _ = _cells(60)
    row2, col2, ok2, obs2, levels2, _ = _cells(61)
    probs, obss = t(np.stack([levels, levels2])), t(np.stack([obs, obs2]))
    rows, cols, oks = (t(np.stack([a, b, a])) for a, b in
                       ((row, row2), (col, col2), (ok, ok2)))
    idx = torch.tensor([1, 0, 0])
    s, k = csm.sweep_windows(probs, obss, rows, cols, oks, -2, -3, ny=5,
                             nx=4, stride=2, map_index=idx)
    for n, m in enumerate((1, 0, 0)):
        s1, k1 = csm.sweep_windows(probs[m], obss[m], rows[n], cols[n],
                                   oks[n], -2, -3, ny=5, nx=4, stride=2)
        assert torch.equal(s[n], s1) and torch.equal(k[n], k1)


@pytest.fixture(scope="module")
def room():
    rng = np.random.default_rng(3)
    true = np.array([0.4, -0.3, 0.2])
    gm, _ = build_map([np.zeros(3)] * 5 + [true] * 5, rng=rng)
    scan = make_scan_arrays(true)
    probf, obs = np.asarray(gm.prob), np.asarray(gm.observed)
    return dict(true=true, scan=scan, obs=obs, offset_xy=gm.offset_xy,
                maps=dict(u8=np.asarray(jquant.quantize_prob_f32(gm.prob)),
                          f32=probf),
                pscan=reference.scan_arrays(
                    *(np.asarray(a) for a in (scan.ranges, scan.angles,
                                              scan.mask)),
                    "cpu", rel_sensor_pose=scan.rel_sensor_pose,
                    num_valid=scan.num_valid))


GATHER = dict(crop_rows=256, crop_cols=256, n_theta_max=48,
              sweep_backend="gather")


@pytest.mark.parametrize("map_type", ["u8", "f32"])
def test_gather_core_matches_reference(room, map_type):
    """The core with ``sweep_backend="gather"`` (top-K fine sweep over the
    whole window) and its dense form, against the JAX core; the batched
    core of two candidates equals the serial core bit for bit."""
    prob = room["maps"][map_type]
    jcfg = jcor.CorrelativeConfig(**GATHER)
    pcfg = reference.correlative_config(dataclasses.asdict(jcfg))
    assert pcfg.sweep_backend == "gather"
    pmap = reference.map_raster(prob, room["obs"], room["offset_xy"], RES,
                                "cpu")
    jmap = MapRaster(jnp.asarray(prob), jnp.asarray(room["obs"]), RES,
                     room["offset_xy"])
    n = room["scan"].num_valid
    s = room["scan"]
    poses = (room["true"] + np.array([[0.08, -0.09, 0.13],
                                      [-0.06, 0.04, -0.1]])).astype(np.float32)
    off = np.asarray(room["offset_xy"], np.float32)
    cp, co = pcor.coarse_of(pmap, pcfg.low_resolution)
    for dense in (False, True):
        for pose in poses:
            j = jcor.correlative_core_jit(
                jcfg, jmap.prob, jmap.observed, None, None, s.ranges, s.angles,
                s.mask, jnp.asarray(pose), jnp.asarray(off), jnp.float32(0.0),
                jnp.float32(0.0), dense=dense)
            p = pcor.correlative_core(
                pcfg, pmap.prob, pmap.observed, cp, co, room["pscan"].ranges,
                room["pscan"].angles, room["pscan"].mask, t(pose), t(off),
                0.0, 0.0, dense=dense)
            np.testing.assert_allclose(p[0].numpy(), np.asarray(j[0]),
                                       atol=POSE_TOL, rtol=0)
            assert abs(float(p[1]) - float(j[1])) <= (2 + SCORE_ATOL) / n
            for k in (3, 6, 7, 8):  # found, processed, total, exact
                assert bool(p[k] == int(j[k])), (k, p[k], j[k])
    beams = [torch.stack([getattr(room["pscan"], k)] * 2)
             for k in ("ranges", "angles", "mask")]
    batch = pcor.correlative_core_batch(
        pcfg, pmap.prob, pmap.observed, cp, co, *beams, t(poses),
        t(np.stack([off, off])), 0.0, 0.0)
    for i, pose in enumerate(poses):
        one = pcor.correlative_core(
            pcfg, pmap.prob, pmap.observed, cp, co, *(b[i] for b in beams),
            t(pose), t(off), 0.0, 0.0)
        for a, b in zip(batch, one):
            assert torch.equal(a[i], b)


def test_gather_matcher_recovers_the_pose(room):
    """The matcher with the gather backend on the u8 room finds the true
    pose within a cell, as the JAX package's own test asks of it."""
    pcfg = reference.correlative_config(dataclasses.asdict(
        jcor.CorrelativeConfig(**GATHER)))
    pm = pcor.ScanMatcherCorrelative(pcfg, "cpu")
    pmap = reference.map_raster(room["maps"]["u8"], room["obs"],
                                room["offset_xy"], RES, "cpu")
    init = room["true"] + np.array([0.08, -0.09, 0.13])
    ps = pm.optimize_pose(PScanMatchingQuery(pmap, room["pscan"], init))
    js = jcor.ScanMatcherCorrelative(jcor.CorrelativeConfig(**GATHER)) \
        .optimize_pose(ScanMatchingQuery(MapRaster(
            jnp.asarray(room["maps"]["u8"]), jnp.asarray(room["obs"]), RES,
            room["offset_xy"]), room["scan"], init))
    assert ps.pose_found and js.pose_found
    np.testing.assert_allclose(ps.estimated_pose, js.estimated_pose,
                               atol=POSE_TOL, rtol=0)
    assert np.abs(ps.estimated_pose - room["true"])[:2].max() <= 1.5 * RES
    with pytest.raises(ValueError):
        pcor.correlative_core(
            dataclasses.replace(pcfg, sweep_backend="conv"), pmap.prob,
            pmap.observed, None, None, room["pscan"].ranges,
            room["pscan"].angles, room["pscan"].mask,
            t(init.astype(np.float32)),
            t(np.asarray(room["offset_xy"], np.float32)), 0.0, 0.0)


# ---- the rasterizer -------------------------------------------------------
def _ambiguous_cells(s_xy, hits, mask, K, off, shape):
    """Cells a sample or hit may fall in under one package and not the
    other: for a point within 2e-4 cells of a cell edge (in f64), the cells
    on both sides of that edge.  A moved sample changes only the cells it
    moves between (its own miss, and the duplicate test of its
    neighbours, which lie in them too); a moved hit its cells likewise."""
    t_ = (np.arange(K) + 0.5) / K
    d = hits.astype(np.float64) - s_xy
    pts = np.concatenate([
        (s_xy + d[:, None, :] * t_[None, :, None])[mask].reshape(-1, 2),
        hits[mask].astype(np.float64)])
    u = (pts - off) / RES
    near = np.abs(u - np.round(u)) < 2e-4
    out = np.zeros(shape, bool)
    for (uc, ur), (nc, nr) in zip(u[near.any(1)], near[near.any(1)]):
        rows = [round(ur) - 1, round(ur)] if nr else [int(np.floor(ur))]
        cols = [round(uc) - 1, round(uc)] if nc else [int(np.floor(uc))]
        for r in rows:
            for c in cols:
                if 0 <= r < shape[0] and 0 <= c < shape[1]:
                    out[r, c] = True
    return out


def _multi_hit_scan(seed, B=512, n_cells=8):
    """512 beams ending in 8 cells (within 1 cm of 8 points)."""
    rng = np.random.default_rng(seed)
    targets = rng.uniform(-5, 5, (n_cells, 2))
    hits = (targets[rng.integers(0, n_cells, B)]
            + rng.uniform(0, 0.01, (B, 2))).astype(np.float32)
    return (np.float32([0.11, -0.07]), hits, rng.uniform(size=B) < 0.95)


@pytest.mark.parametrize("backend", ["matmul", "scatter"])
@pytest.mark.parametrize("seed", [0, 1])
def test_multi_hit_delta_equals_reference_bitwise(backend, seed):
    """Part of ROADMAP 3.12's repair: a cell many beams end in adds
    ``logodds_hit`` once per hit, as the JAX scatter does, so the deltas
    are equal bit for bit (before, the port's one multiply differed there
    by up to 1.14e-5)."""
    s_xy, hits, mask = _multi_hit_scan(seed)
    shape, K, off = (256, 256), 768, np.float32([-6.4, -6.4])
    j = np.asarray(jras.scan_delta(
        shape, jnp.asarray(s_xy), jnp.asarray(hits), jnp.asarray(mask), RES,
        jnp.asarray(off), LH, LM, num_samples=K, backend=backend, crop=256))
    p = rasterize.scan_delta(shape, t(s_xy), t(hits), t(mask), RES, t(off),
                             LH, LM, num_samples=K, crop=256,
                             backend=backend).numpy()
    skip = _ambiguous_cells(s_xy, hits, mask, K, off, shape)
    assert skip.mean() < 0.01 and (p != j).mean() <= 2e-3
    r = np.floor((hits[mask] - off) / RES).astype(int)
    cells, counts = np.unique(r[:, ::-1], axis=0, return_counts=True)
    multi = [tuple(c) for c, n in zip(cells, counts)
             if n >= 10 and not skip[tuple(c)]]
    assert len(multi) >= 6, multi
    for c in multi:
        assert p[c] == j[c] and p[c] > 10 * LH - 1e-3
    np.testing.assert_array_equal(p[~skip], j[~skip])


def _scan_geometry(rng, B=96, max_range=4.0):
    s_xy = np.float32([0.13, -0.21])
    ang = np.linspace(-2.5, 2.5, B) + rng.normal(0, 0.01, B)
    r = rng.uniform(0.5, max_range, B)
    hits = np.stack([s_xy[0] + r * np.cos(ang), s_xy[1] + r * np.sin(ang)], -1)
    return s_xy, hits.astype(np.float32), rng.uniform(size=B) < 0.9


def test_scatter_delta_and_integrate_equal_reference():
    """The scatter backend: one add of ``logodds_miss`` per miss sample over
    the whole raster, then the hits; ``scan_delta`` and a two-scan
    ``integrate_scans`` equal the JAX scatter where the sample cells
    agree, and differ from the matmul backend (another rounding)."""
    rng = np.random.default_rng(5)
    shape, K, off = (160, 160), 200, np.float32([-4.0, -4.0])
    s_xy, hits, mask = _scan_geometry(rng)
    j = np.asarray(jras.scan_delta(
        shape, jnp.asarray(s_xy), jnp.asarray(hits), jnp.asarray(mask), RES,
        jnp.asarray(off), LH, LM, num_samples=K, backend="scatter"))
    p = rasterize.scan_delta(shape, t(s_xy), t(hits), t(mask), RES, t(off),
                             LH, LM, num_samples=K,
                             backend="scatter").numpy()
    skip = _ambiguous_cells(s_xy, hits, mask, K, off, shape)
    assert skip.mean() < 0.01 and (p != j).mean() <= 2e-3
    assert (np.abs(p) > 0).sum() > 500
    np.testing.assert_array_equal(p[~skip], j[~skip])
    matmul = rasterize.scan_delta(shape, t(s_xy), t(hits), t(mask), RES,
                                  t(off), LH, LM, num_samples=K).numpy()
    assert (matmul != p).any()

    sensors = np.stack([s_xy, s_xy + 0.3]).astype(np.float32)
    hits2 = np.stack([hits, hits + np.float32(0.3)])
    masks = np.stack([mask, mask])
    skip2 = skip | _ambiguous_cells(sensors[1], hits2[1], mask, K, off, shape)
    lj, oj, nj = jras.integrate_scans(
        jnp.zeros(shape), jnp.zeros(shape, bool), jnp.asarray(sensors),
        jnp.asarray(hits2), jnp.asarray(masks), RES, jnp.asarray(off), LH, LM,
        num_samples=K, backend="scatter", return_oob=True)
    lp, op, n_p = rasterize.integrate_scans(
        torch.zeros(shape), torch.zeros(shape, dtype=torch.bool), t(sensors),
        t(hits2), t(masks), RES, t(off), LH, LM, num_samples=K,
        backend="scatter")
    assert int(n_p) == int(nj)
    np.testing.assert_array_equal(lp.numpy()[~skip2], np.asarray(lj)[~skip2])
    np.testing.assert_array_equal(op.numpy()[~skip2], np.asarray(oj)[~skip2])


def test_backend_names_are_checked():
    assert GridMapBuilderConfig(rasterize_backend="scatter")
    with pytest.raises(ValueError):
        GridMapBuilderConfig(rasterize_backend="conv")
    with pytest.raises(ValueError):
        rasterize.scan_delta((8, 8), torch.zeros(2), torch.ones(3, 2),
                             torch.ones(3, dtype=torch.bool), RES,
                             torch.zeros(2), LH, LM, backend="conv")
