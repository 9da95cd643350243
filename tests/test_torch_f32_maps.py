"""The port's sweeps and matchers on f32 probability maps and at every
precision, against the JAX package's on the CPU.

Inputs come from seeded NumPy generators (or the JAX package's own test
scenes) and go to both packages as NumPy arrays.

Tolerances, fixed before the first run, and why:
- known counts: equal (sums of 0/1 on both sides);
- scores of the f32 sweeps: atol 2e-3.  Both round the window alike
  (``"fast"``: bf16; ``"split"``: the bf16 hi + lo parts), then the JAX
  package rounds each f32 add of its two partial sums and the port sums
  the rounded window exactly in f64 and rounds once: at most a few f32
  ulps of a score below 512;
- the int8 forms: equal (integer arithmetic on both sides, wrapped counts
  included);
- the matchers: the same found flag, and poses within 1e-4 m / rad, so
  the same winning cell (a cell is 0.05 m, a theta step above 1e-3 rad);
  the normalised score within (2 + 2e-3) / n: the scores' own tolerance,
  plus two beams whose cell the two packages' f32 trig puts on either side
  of a cell edge (JAX's compiled trig and its eager trig differ there too).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.matching import branch_bound as jbb
from my_lidar_graph_slam_v2_tpu.matching import correlative as jcor
from my_lidar_graph_slam_v2_tpu.matching import grid_search as jgs
from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster, ScanMatchingQuery
from my_lidar_graph_slam_v2_tpu.ops import csm as jcsm
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.matching import branch_bound as pbb
from my_lidar_graph_slam_v2_tpu_torch.matching import correlative as pcor
from my_lidar_graph_slam_v2_tpu_torch.matching import grid_search as pgs
from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
    ScanMatchingQuery as PScanMatchingQuery,
)
from my_lidar_graph_slam_v2_tpu_torch.ops import csm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from tests.test_matchers import RES, build_map, make_scan_arrays

SCORE_ATOL = 2e-3
POSE_TOL = 1e-4
PRECISIONS = ["fast", "split", "highest"]


def t(a):
    return torch.as_tensor(np.array(a))


def _f32_map(rng, H, W):
    """Probabilities in [1e-3, 1 - 1e-3] (the clamp of grid/values.py)
    where observed, 0 elsewhere."""
    obs = rng.uniform(size=(H, W)) < 0.7
    prob = np.where(obs, rng.uniform(1e-3, 1 - 1e-3, (H, W)), 0)
    return prob.astype(np.float32), obs


def _scan(rng, B, max_range=2.0):
    ranges = rng.uniform(0.4, max_range, B).astype(np.float32)
    angles = np.sort(rng.uniform(-np.pi, np.pi, B)).astype(np.float32)
    mask = rng.uniform(size=B) < 0.9
    return ranges, angles, mask


def _jax_cells(ranges, angles, mask, pose, off, T, crop):
    step, t0, tmask = jcsm.theta_search_params(
        jnp.asarray(ranges), jnp.asarray(mask), RES, 0.3, T)
    cells = jcsm.beam_cells(
        jnp.asarray(ranges), jnp.asarray(angles), jnp.asarray(mask),
        jnp.asarray(pose), t0, step, tmask, RES, jnp.asarray(off), n_theta=T,
        crop_rows=crop, crop_cols=crop)
    return (step, t0, tmask), cells


@pytest.fixture(scope="module")
def sweep_case():
    rng = np.random.default_rng(40)
    H, W, T, crop = 120, 110, 12, 64
    prob, obs = _f32_map(rng, H, W)
    ranges, angles, mask = _scan(rng, 80, max_range=1.4)
    pose = np.float32([0.05, -0.03, 0.2])
    off = np.float32([-3.0, -2.7])
    theta, (hr, hc, valid, r0, c0) = _jax_cells(ranges, angles, mask, pose,
                                                off, T, crop)
    img = jcsm.build_hit_images(hr, hc, valid, theta[2], crop_rows=crop,
                                crop_cols=crop)
    return dict(prob=prob, obs=obs, ranges=ranges, angles=angles, mask=mask,
                pose=pose, off=off, T=T, crop=crop, theta=theta,
                cells=(hr, hc, valid, r0, c0), img=img)


def _pimg(c):
    return t(np.asarray(c["img"].astype(jnp.float32)))


def _anchors(c):
    r0, c0 = c["cells"][3:]
    return (torch.tensor(int(r0), dtype=torch.int32),
            torch.tensor(int(c0), dtype=torch.int32))


def _assert_sweep(got, ref):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=SCORE_ATOL)
    assert float(got[0].max()) > 1.0


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("nx,ny,stride", [(9, 7, 1), (4, 3, 5)])
def test_sweep_from_hits_on_f32_maps(sweep_case, precision, nx, ny, stride):
    c = sweep_case
    r0, c0 = c["cells"][3:]
    ref = jcsm.sweep_from_hits(
        c["img"], r0, c0, jnp.asarray(c["prob"]), jnp.asarray(c["obs"]),
        jnp.int32(-4), jnp.int32(-3), nx=nx, ny=ny, stride=stride,
        precision=precision)
    got = csm.sweep_from_hits(_pimg(c), *_anchors(c), t(c["prob"]),
                              t(c["obs"]), -4, -3, nx=nx, ny=ny,
                              stride=stride, precision=precision)
    assert got[0].shape == (c["T"], ny, nx)
    _assert_sweep(got, ref)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_sweep_from_hits_at_on_f32_maps(sweep_case, precision):
    c = sweep_case
    r0, c0 = c["cells"][3:]
    rng = np.random.default_rng(41)
    off = rng.integers(-2, 14, (30, 2)).astype(np.int32)  # some clipped
    ref = jcsm.sweep_from_hits_at(
        c["img"], r0, c0, jnp.asarray(c["prob"]), jnp.asarray(c["obs"]),
        jnp.int32(-5), jnp.int32(-6), jnp.asarray(off), max_j=11, max_i=12,
        precision=precision)
    got = csm.sweep_from_hits_at(_pimg(c), *_anchors(c), t(c["prob"]),
                                 t(c["obs"]), -5, -6, t(off), max_j=11,
                                 max_i=12, precision=precision)
    assert got[0].shape == (c["T"], 30)
    _assert_sweep(got, ref)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_csm_sweep_on_f32_maps(sweep_case, precision):
    """The one-call sweep from the scan: the port's own beam cells must
    equal the JAX package's on this seed (checked), then the sweeps agree
    within the score tolerance, known exactly; an unknown precision raises
    as in the JAX package."""
    c = sweep_case
    step, t0, tmask = c["theta"]
    kw = dict(n_theta=c["T"], nx=7, ny=6, stride=1, crop_rows=c["crop"],
              crop_cols=c["crop"])
    ref = jcsm.csm_sweep(
        jnp.asarray(c["prob"]), jnp.asarray(c["obs"]),
        *(jnp.asarray(c[k]) for k in ("ranges", "angles", "mask", "pose")),
        t0, step, tmask, jnp.int32(-3), jnp.int32(-2), RES,
        jnp.asarray(c["off"]), precision=precision, **kw)
    pargs = (t(c["prob"]), t(c["obs"]),
             *(t(c[k]) for k in ("ranges", "angles", "mask", "pose")),
             t(t0), t(step), t(tmask), -3, -2, RES, t(c["off"]))
    ph, pc, pv, _, _ = csm.beam_cells(*pargs[2:9], RES, t(c["off"]),
                                      n_theta=c["T"], crop_rows=c["crop"],
                                      crop_cols=c["crop"])
    hr, hc, valid = (np.asarray(a) for a in c["cells"][:3])
    assert np.array_equal(ph.numpy(), hr) and np.array_equal(pc.numpy(), hc)
    got = csm.csm_sweep(*pargs, precision=precision, **kw)
    _assert_sweep(got, ref)
    with pytest.raises(ValueError, match="precision"):
        csm.csm_sweep(*pargs, precision="bf16", **kw)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_sweep_windows_on_f32_maps(sweep_case, precision):
    """The gather sweep ignores the precision in both packages (f32
    contraction there, the exact sum here), on map cells with beams off
    the map on every side."""
    c = sweep_case
    step, t0, tmask = c["theta"]
    row, col, ok = jcsm.beam_cells_abs(
        *(jnp.asarray(c[k]) for k in ("ranges", "angles", "mask", "pose")),
        t0, step, tmask, RES, jnp.asarray(c["off"]), n_theta=c["T"])
    row = np.asarray(row).copy()
    col = np.asarray(col).copy()
    row[:, :3], col[:, 3:6] = -4, 115  # off the map: read 0
    ref = jcsm.sweep_windows(jnp.asarray(c["prob"]), jnp.asarray(c["obs"]),
                             jnp.asarray(row), jnp.asarray(col), ok,
                             jnp.int32(-5), jnp.int32(-4), ny=4, nx=5,
                             stride=2)
    got = csm.sweep_windows(t(c["prob"]), t(c["obs"]), t(row), t(col),
                            t(ok), -5, -4, ny=4, nx=5, stride=2)
    pr, pc, pok = csm.beam_cells_abs(
        *(t(c[k]) for k in ("ranges", "angles", "mask", "pose")), t(t0),
        t(step), t(tmask), RES, t(c["off"]), n_theta=c["T"])
    assert np.array_equal(pok.numpy(), np.asarray(ok))
    assert (pr.numpy() != np.asarray(jcsm.beam_cells_abs(
        *(jnp.asarray(c[k]) for k in ("ranges", "angles", "mask", "pose")),
        t0, step, tmask, RES, jnp.asarray(c["off"]),
        n_theta=c["T"])[0])).mean() < 5e-3
    _assert_sweep(got, ref)


def test_int8_hit_images_and_sweep_equal_reference():
    """``build_hit_images(dtype=int8)`` and ``sweep_from_hits_int8`` equal
    the JAX package's exactly, with 200 beams of one theta in one cell
    (the count wraps to -56 in both)."""
    rng = np.random.default_rng(42)
    T, B, crop = 6, 260, 40
    hr = rng.integers(0, crop, (T, B)).astype(np.int32)
    hc = rng.integers(0, crop, (T, B)).astype(np.int32)
    hr[2, :200], hc[2, :200] = 7, 9
    valid = rng.uniform(size=(T, B)) < 0.9
    valid[2, :200] = True
    tmask = np.array([True, True, True, False, True, True])
    jimg = jcsm.build_hit_images(*(jnp.asarray(a) for a in (hr, hc, valid,
                                                            tmask)),
                                 crop_rows=crop, crop_cols=crop,
                                 dtype=jnp.int8)
    pimg = csm.build_hit_images(t(hr), t(hc), t(valid), t(tmask),
                                crop_rows=crop, crop_cols=crop,
                                dtype=torch.int8)
    assert pimg.dtype == torch.int8 and int(pimg[2, 7, 9]) == -56
    np.testing.assert_array_equal(pimg.numpy(), np.asarray(jimg))
    with pytest.raises(ValueError):
        csm.build_hit_images(t(hr), t(hc), t(valid), t(tmask),
                             crop_rows=crop, crop_cols=crop,
                             dtype=torch.int16)

    win = np.stack([rng.integers(0, 256, (crop + 12, crop + 9)),
                    255 * (rng.uniform(size=(crop + 12, crop + 9)) < 0.7)],
                   -1).astype(np.uint8)
    rc = (valid & tmask[:, None]).sum(1).astype(np.float32)
    for nx, ny, stride in ((10, 13, 1), (3, 4, 4)):
        ref = jcsm.sweep_from_hits_int8(
            jimg, jnp.asarray(rc), jnp.asarray(win.transpose(2, 0, 1)),
            nx=nx, ny=ny, stride=stride)
        got = csm.sweep_from_hits_int8(pimg, t(rc), t(win), nx=nx, ny=ny,
                                       stride=stride)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---- the matchers on f32 maps ---------------------------------------------
@pytest.fixture(scope="module")
def scenes():
    """The JAX package's two matcher scenes as f32 probability maps:
    ``tests/test_matchers.py``'s room seen 5 + 5 times (seed 3) and the
    seed-21 scene of ``tests/test_more_matchers.py``."""
    out = {}
    for name, seed, n, true in (("room", 3, 5, [0.4, -0.3, 0.2]),
                                ("seed21", 21, 16, [0.35, -0.25, 0.12])):
        rng = np.random.default_rng(seed)
        true = np.array(true)
        gm, _ = build_map([np.zeros(3)] * n + [true] * n, rng=rng)
        scan = make_scan_arrays(true)
        prob, obs = np.asarray(gm.prob), np.asarray(gm.observed)
        out[name] = dict(
            true=true, scan=scan, jmap=MapRaster(
                jnp.asarray(prob), jnp.asarray(obs), RES, gm.offset_xy),
            pmap=reference.map_raster(prob, obs, gm.offset_xy, RES, "cpu"),
            pscan=reference.scan_arrays(
                *(np.asarray(a) for a in (scan.ranges, scan.angles,
                                          scan.mask)),
                "cpu", rel_sensor_pose=scan.rel_sensor_pose,
                num_valid=scan.num_valid))
        assert out[name]["pmap"].prob.dtype == torch.float32
    return out


def _score_tol(n):
    return (2.0 + SCORE_ATOL) / n


def _assert_same_match(js, ps, n):
    assert ps.pose_found == js.pose_found
    np.testing.assert_allclose(ps.estimated_pose, js.estimated_pose,
                               atol=POSE_TOL, rtol=0)
    if ps.pose_found:
        assert abs(ps.normalized_score - js.normalized_score) <= _score_tol(n)


CORR = dict(crop_rows=256, crop_cols=256, n_theta_max=48)


@pytest.mark.parametrize("scene,precision", [("room", "highest"),
                                              ("seed21", "split")])
def test_correlative_matcher_on_f32_maps(scenes, scene, precision):
    """The serial matcher on each scene (the batched test below runs both
    scenes at both precisions)."""
    s = scenes[scene]
    jcfg = jcor.CorrelativeConfig(**CORR, precision=precision)
    pm = pcor.ScanMatcherCorrelative(
        reference.correlative_config(dataclasses.asdict(jcfg)), "cpu")
    init = s["true"] + np.array([0.08, -0.09, 0.13])
    js = jcor.ScanMatcherCorrelative(jcfg).optimize_pose(
        ScanMatchingQuery(s["jmap"], s["scan"], init))
    ps = pm.optimize_pose(PScanMatchingQuery(s["pmap"], s["pscan"], init))
    _assert_same_match(js, ps, s["scan"].num_valid)
    assert ps.pose_found


@pytest.mark.parametrize("precision", ["highest", "split"])
def test_batched_core_on_f32_maps_equals_serial_and_reference(scenes,
                                                              precision):
    """Three candidates on the two scenes' maps as one stack: each row of
    the batched core equals the serial core bit for bit and the JAX
    core's pose within the tolerance."""
    names = ["room", "seed21", "room"]
    offs = np.array([[0.08, -0.09, 0.13], [-0.1, 0.05, -0.05],
                     [0.02, 0.1, 0.0]])
    jcfg = jcor.CorrelativeConfig(**CORR, precision=precision)
    pcfg = reference.correlative_config(dataclasses.asdict(jcfg))
    maps = [scenes["room"]["pmap"], scenes["seed21"]["pmap"]]
    idx = torch.tensor([0, 1, 0])
    sc = [scenes[n] for n in names]
    beams = [torch.stack([getattr(s["pscan"], k) for s in sc])
             for k in ("ranges", "angles", "mask")]
    poses = torch.tensor(np.stack([s["true"] + o for s, o in zip(sc, offs)]),
                         dtype=torch.float32)
    moff = torch.tensor(np.stack([np.asarray(s["pmap"].offset_xy)
                                  for s in sc]), dtype=torch.float32)
    batch = pcor.correlative_core_batch(
        pcfg, torch.stack([m.prob for m in maps]),
        torch.stack([m.observed for m in maps]), None, None, *beams, poses,
        moff, 0.0, 0.0, map_index=idx)
    for n, s in enumerate(sc):
        serial = pcor.correlative_core(
            pcfg, s["pmap"].prob, s["pmap"].observed, None, None,
            *(b[n] for b in beams), poses[n], moff[n], 0.0, 0.0)
        for a, b in zip(batch, serial):
            assert torch.equal(a[n], b)
        j = jcor.correlative_core_jit(
            jcfg, s["jmap"].prob, s["jmap"].observed, None, None,
            s["scan"].ranges, s["scan"].angles, s["scan"].mask,
            jnp.asarray(poses[n].numpy()), jnp.asarray(moff[n].numpy()),
            jnp.float32(0.0), jnp.float32(0.0))
        np.testing.assert_allclose(batch[0][n].numpy(), np.asarray(j[0]),
                                   atol=POSE_TOL, rtol=0)
        assert bool(batch[3][n]) == bool(j[3])
        assert bool(batch[8][n]) == bool(j[8])
        assert abs(float(batch[1][n]) - float(j[1])) <= _score_tol(
            s["scan"].num_valid)


GS = dict(range_x=0.4, range_y=0.4, range_theta=0.1, step_theta=0.01,
          crop_rows=256, crop_cols=256)


@pytest.mark.parametrize("precision", ["highest", "split"])
@pytest.mark.parametrize("steps", ["integer", "arbitrary"])
def test_grid_search_on_f32_maps(scenes, steps, precision):
    s = scenes["seed21"]
    kw = dict(GS, precision=precision)
    if steps == "arbitrary":
        kw.update(range_x=0.3, range_y=0.3, step_x=0.03, step_y=0.03,
                  step_theta=0.02)
    jcfg = jgs.GridSearchConfig(**kw)
    assert jcfg.integer_steps == (steps == "integer")
    init = s["true"] + np.array([0.1, -0.08, 0.04])
    js = jgs.ScanMatcherGridSearch(jcfg).optimize_pose(
        ScanMatchingQuery(s["jmap"], s["scan"], init), 0.3, 0.5)
    ps = pgs.ScanMatcherGridSearch(
        reference.grid_search_config(dataclasses.asdict(jcfg)),
        "cpu").optimize_pose(
        PScanMatchingQuery(s["pmap"], s["pscan"], init), 0.3, 0.5)
    assert ps.pose_found
    _assert_same_match(js, ps, s["scan"].num_valid)


@pytest.mark.parametrize("precision", ["highest", "split"])
def test_branch_bound_on_f32_maps(scenes, precision):
    s = scenes["seed21"]
    jcfg = jbb.BranchBoundConfig(node_height_max=4, range_x=1.0, range_y=1.0,
                                 range_theta=0.2, n_theta_max=32,
                                 crop_rows=256, crop_cols=256,
                                 precision=precision)
    init = s["true"] + np.array([0.3, -0.3, 0.1])
    js = jbb.ScanMatcherBranchBound(jcfg).optimize_pose(
        ScanMatchingQuery(s["jmap"], s["scan"], init), 0.2, 0.1)
    pm = pbb.ScanMatcherBranchBound(
        reference.branch_bound_config(dataclasses.asdict(jcfg)), "cpu")
    ps = pm.optimize_pose(PScanMatchingQuery(s["pmap"], s["pscan"], init),
                          0.2, 0.1)
    assert ps.pose_found and pm.blocks_swept >= 1
    _assert_same_match(js, ps, s["scan"].num_valid)
