"""Parity of the port's device ops with the JAX package's: pose algebra,
u8 quantization, sliding-window max, rasterization and Gauss-Newton.

Inputs come from a seeded NumPy generator and go to both packages as
NumPy arrays.  Each tolerance is stated with its reason beside it.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.core import pose as JP
from my_lidar_graph_slam_v2_tpu.ops import gauss_newton as jgn
from my_lidar_graph_slam_v2_tpu.ops import pool as jpool
from my_lidar_graph_slam_v2_tpu.ops import quant as jquant
from my_lidar_graph_slam_v2_tpu.ops import rasterize as jras
from my_lidar_graph_slam_v2_tpu_torch.core import pose as P
from my_lidar_graph_slam_v2_tpu_torch.ops import gauss_newton, pool, quant, rasterize
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_pose_algebra():
    """NumPy inputs run the same f64 formulas in both packages (equal);
    torch f32 inputs agree with them to f32 rounding (atol 1e-5 on
    values of order 10)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-10, 10, (32, 3))
    b = rng.uniform(-10, 10, (32, 3))
    cov = rng.normal(size=(32, 3, 3))
    cov = cov @ np.swapaxes(cov, 1, 2)
    cases = [
        ("compound", (a, b)), ("inverse_compound", (a, b)),
        ("move_backward", (a, b)), ("normalize_pose", (a,)),
        ("distance", (a, b)), ("covariance_world_to_local", (a, cov)),
        ("covariance_local_to_world", (a, cov)),
    ]
    for name, args in cases:
        ref = getattr(JP, name)(*args)
        np.testing.assert_array_equal(getattr(P, name)(*args), ref)
        got = getattr(P, name)(*[_t(x.astype(np.float32)) for x in args])
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * (1 + np.abs(ref).max()))


def test_quantize_flips_bounded():
    """``round(sigmoid(lo) * 255)``: torch's and XLA's f32 sigmoid may
    differ in the last ulp, which moves a level only where p * 255 lies
    within an ulp of a .5 boundary.  Bound: levels differ by at most 1,
    in at most 0.1% of cells; dequantization is exact."""
    rng = np.random.default_rng(1)
    lo = rng.normal(0, 3, (256, 256)).astype(np.float32)
    obs = rng.uniform(size=lo.shape) < 0.8
    j = np.asarray(jquant.quantize_prob(jnp.asarray(lo), jnp.asarray(obs)))
    p = quant.quantize_prob(_t(lo), _t(obs)).numpy()
    d = np.abs(p.astype(int) - j.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).sum())
    np.testing.assert_array_equal(
        quant.dequant_prob(_t(j)).numpy(), np.asarray(jquant.dequant_prob(jnp.asarray(j)))
    )


@pytest.mark.parametrize("dtype", ["u8", "f32", "bool"])
@pytest.mark.parametrize("win", [1, 2, 5, 7])
def test_sliding_window_max_exact(dtype, win):
    rng = np.random.default_rng(win)
    if dtype == "u8":
        a = rng.integers(0, 256, (2, 37, 41)).astype(np.uint8)
    elif dtype == "f32":
        a = rng.normal(size=(37, 41)).astype(np.float32)
    else:
        a = rng.uniform(size=(37, 41)) < 0.1
    j = np.asarray(jpool.sliding_window_max2d(jnp.asarray(a), win))
    p = pool.sliding_window_max2d(_t(a), win).numpy()
    assert p.dtype == j.dtype
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("crop", [96, 40])
def test_miss_counts_exact(crop):
    """Given the same sample cells, the port's int32 counts equal the JAX
    one-hot matmul counts, crop window (crop 40 < spread drops samples)
    included."""
    rng = np.random.default_rng(crop)
    h = w = 96
    rows = rng.integers(-5, h + 5, (64, 50)).astype(np.int32)
    cols = rng.integers(-5, w + 5, (64, 50)).astype(np.int32)
    valid = ((rng.uniform(size=rows.shape) < 0.8)
             & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w))
    j = np.asarray(jras._miss_counts_matmul(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(valid), h, w, crop, 512,
    ))
    p = rasterize._miss_counts(_t(rows), _t(cols), _t(valid), h, w, crop).numpy()
    np.testing.assert_array_equal(p, j.astype(np.int32))


def _scan_geometry(rng, B=96, max_range=4.0):
    s_xy = np.float32([0.13, -0.21])
    ang = np.linspace(-2.5, 2.5, B) + rng.normal(0, 0.01, B)
    r = rng.uniform(0.5, max_range, B)
    hits = np.stack([s_xy[0] + r * np.cos(ang), s_xy[1] + r * np.sin(ang)], -1)
    mask = rng.uniform(size=B) < 0.9
    return s_xy, hits.astype(np.float32), mask


LH = float(np.log(0.62 / 0.38))
LM = float(np.log(0.46 / 0.54))


def test_scan_delta_and_integrate():
    """Sample cells are ``floor(f32 / res)``: an ulp apart between the two
    packages only where a sample sits on a cell edge.  Bounds: the delta
    images differ in at most 0.2% of cells; elsewhere they are equal bit
    for bit (a cell hit by two or more beams adds ``logodds_hit`` once per
    hit in both).  The integrated maps obey the same bounds."""
    rng = np.random.default_rng(5)
    shape, K, res = (160, 160), 200, 0.05
    off = np.float32([-4.0, -4.0])
    s_xy, hits, mask = _scan_geometry(rng)
    j = np.asarray(jras.scan_delta(
        shape, jnp.asarray(s_xy), jnp.asarray(hits), jnp.asarray(mask), res,
        jnp.asarray(off), LH, LM, num_samples=K, backend="matmul", crop=160,
    ))
    p = rasterize.scan_delta(shape, _t(s_xy), _t(hits), _t(mask), res, _t(off),
                             LH, LM, num_samples=K, crop=160).numpy()
    close = p == j
    assert (~close).mean() <= 2e-3, (~close).sum()
    assert (np.abs(p) > 0).sum() > 500  # a real scan's worth of cells

    sensors = np.stack([s_xy, s_xy + 0.3]).astype(np.float32)
    hits2 = np.stack([hits, hits + np.float32(0.3)])
    masks = np.stack([mask, mask])
    lo0 = np.zeros(shape, np.float32)
    obs0 = np.zeros(shape, bool)
    lj, oj, nj = jras.integrate_scans(
        jnp.asarray(lo0), jnp.asarray(obs0), jnp.asarray(sensors),
        jnp.asarray(hits2), jnp.asarray(masks), res, jnp.asarray(off), LH, LM,
        num_samples=K, backend="matmul", crop=160, return_oob=True,
    )
    lp, op, n_p = rasterize.integrate_scans(
        _t(lo0), _t(obs0), _t(sensors), _t(hits2), _t(masks), res, _t(off),
        LH, LM, num_samples=K, crop=160,
    )
    assert int(n_p) == int(nj)
    close = lp.numpy() == np.asarray(lj)
    assert (~close).mean() <= 2e-3, (~close).sum()
    assert (op.numpy() != np.asarray(oj)).mean() <= 2e-3


def test_fold_shifted_deltas_exact():
    """The fold adds and clips the same f32 values in the same order, so
    on the same delta images it is exact, shifts clipped to the pad and
    invalid entries included."""
    rng = np.random.default_rng(6)
    S, H, W = 5, 48, 56
    deltas = np.where(rng.uniform(size=(S, H, W)) < 0.3,
                      rng.normal(0, 2, (S, H, W)), 0).astype(np.float32)
    shifts = np.array([[0, 0], [3, -4], [-7, 2], [12, 1], [0, 5]], np.int32)
    valid = np.array([True, True, True, True, False])
    lj, oj = jras.fold_shifted_deltas(jnp.asarray(deltas), jnp.asarray(shifts),
                                      jnp.asarray(valid), max_shift=8)
    lp, op = rasterize.fold_shifted_deltas([_t(d) for d in deltas], shifts,
                                           valid, max_shift=8)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(
        rasterize.prob_map(lp, op).numpy() > 0, np.asarray(jras.prob_map(lj, oj)) > 0
    )


def _gn_case(rng):
    """A u8 map of the test world built from 10 scans, and a scan of it
    taken from a pose the initial guess misses by a cell or two."""
    from tests.test_matchers import build_map, make_scan_arrays

    true = np.array([0.3, -0.2, 0.1])
    gm, _ = build_map([np.zeros(3)] * 5 + [true] * 5, rng=rng)
    prob = np.asarray(jquant.quantize_prob_f32(gm.prob))
    scan = make_scan_arrays(true)
    r, ang, mask = (np.asarray(a) for a in (scan.ranges, scan.angles, scan.mask))
    init = (true + np.array([0.03, -0.02, 0.02])).astype(np.float32)
    return (prob, np.asarray(gm.observed), r, ang, mask, init, true, gm.resolution,
            np.asarray(gm.offset_xy, np.float32))


def test_gauss_newton_parity():
    """f32 reductions over the beams run in another order in torch than in
    XLA, so H, b and the cost agree to rtol 1e-4; the refined pose to
    1e-4 m / rad (a 50th of a cell), the covariance (a 3x3 inverse) to
    rtol 1e-3."""
    rng = np.random.default_rng(7)
    prob, obs, r, ang, mask, init, true, res, off = _gn_case(rng)
    jargs = (jnp.asarray(prob), jnp.asarray(obs), jnp.asarray(r),
             jnp.asarray(ang), jnp.asarray(mask))
    pargs = (_t(prob), _t(obs), _t(r), _t(ang), _t(mask))
    Hj, bj, cj = jgn.hessian_and_residual(*jargs, jnp.asarray(init), res,
                                          jnp.asarray(off))
    Hp, bp, cp = gauss_newton.hessian_and_residual(*pargs, _t(init), res, _t(off))
    np.testing.assert_allclose(Hp.numpy(), np.asarray(Hj), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(bj)).max())
    np.testing.assert_allclose(float(cp), float(cj), rtol=1e-4)

    pj, cj2, ij = jgn.gn_refine(*jargs, jnp.asarray(init), res, jnp.asarray(off))
    pp, cp2, ip = gauss_newton.gn_refine(*pargs, _t(init), res, _t(off))
    np.testing.assert_allclose(pp.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(float(cp2), float(cj2), rtol=1e-4)
    assert int(ip) == int(ij)
    assert np.abs(pp.numpy() - true).max() < 0.05

    covj = jgn.covariance(*jargs, pj, res, jnp.asarray(off))
    covp = gauss_newton.covariance(*pargs, pp, res, _t(off))
    np.testing.assert_allclose(covp.numpy(), np.asarray(covj), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(covj)).max())
