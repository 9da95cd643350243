"""Square-error cost, Gauss-Newton step and pose covariance.

Port of ``my_lidar_graph_slam_v2_tpu/ops/gauss_newton.py``
(``cost_function_square_error.cpp``, ``scan_matcher_linear_solver.cpp``).
The same deliberate deviation from the reference is kept: fractional
indices are shifted by -0.5 so the map is interpolated at cell centres
(see the JAX module's docstring for why).

``gn_refine`` keeps the loop on the device: it always runs
``max_iterations`` masked steps, and a finished state stays frozen.  The
iterate sequence equals the JAX ``while_loop``'s, and no iteration needs
a host sync to test the stop condition.

The trig, the sums over beams and the 3x3 solves go through
``utils/devmath.py`` (f64, rounded once to f32), so a match gives the same
bits on the CPU and on CUDA.

:func:`refine` is the one entry of the matchers (the fused frontend match
and the final linear-solver matcher): initial cost, refinement and
covariance.  On the CPU it is :func:`refine_plain`; on CUDA it is one
launch of the hand-written kernel (``ops/gauss_newton_cuda.py``,
``csrc/gauss_newton.cu``), which gives the same bits.
"""
from __future__ import annotations

import torch

from ..utils import devmath
from ..utils.transfer import f32
from . import gauss_newton_cuda
from .quant import dequant_prob


def _bilinear_values(prob, observed, frow, fcol, map_index=None):
    """Four corner probabilities + fractional offsets for float indices.
    Unknown or out-of-range corners read 0.5; indices are clamped like
    the reference (``cost_function_square_error.cpp:326-351``).  The map
    is one raster ``[H, W]``, or a stack ``[M, H, W]`` with ``map_index``
    (i64 ``[N]``) naming the raster of each row of indices ``[N, B]``."""
    H, W = prob.shape[-2:]
    r0 = torch.floor(frow)
    c0 = torch.floor(fcol)
    dr = frow - r0
    dc = fcol - c0
    rc0 = torch.clamp(r0.to(torch.int32), min=0)
    cc0 = torch.clamp(c0.to(torch.int32), min=0)
    rc1 = torch.clamp(rc0 + 1, max=H - 1)
    cc1 = torch.clamp(cc0 + 1, max=W - 1)
    prob_flat = prob.reshape(-1)
    obs_flat = observed.reshape(-1)

    def read(r, c):
        inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        idx = (torch.clamp(r, 0, H - 1).long() * W
               + torch.clamp(c, 0, W - 1).long())
        if map_index is not None:
            idx = idx + map_index[:, None] * (H * W)
        p = dequant_prob(prob_flat[idx])
        known = obs_flat[idx] & inside
        return torch.where(known, p, 0.5)

    m00 = read(rc0, cc0)
    m01 = read(rc1, cc0)
    m10 = read(rc0, cc1)
    m11 = read(rc1, cc1)
    return m00, m01, m10, m11, dr, dc


def _interp_and_grad(prob, observed, frow, fcol, map_index=None):
    """Smoothed value + scaled gradient (d/d(col), d/d(row))."""
    m00, m01, m10, m11, dr, dc = _bilinear_values(prob, observed, frow, fcol,
                                                  map_index)
    value = dr * (dc * m11 + (1.0 - dc) * m01) + (1.0 - dr) * (
        dc * m10 + (1.0 - dc) * m00
    )
    grad_x = dr * (m11 - m01) + (1.0 - dr) * (m10 - m00)
    grad_y = dc * (m11 - m10) + (1.0 - dc) * (m01 - m00)
    return value, grad_x, grad_y


def _hit_points(sensor_pose, ranges, angles):
    ang = sensor_pose[..., 2, None] + angles
    hx = sensor_pose[..., 0, None] + ranges * devmath.cos(ang)
    hy = sensor_pose[..., 1, None] + ranges * devmath.sin(ang)
    return hx, hy


def _frac_indices(hx, hy, resolution, offset_xy):
    res = f32(resolution, hx.device)
    fcol = torch.div(hx - offset_xy[..., 0, None], res) - 0.5
    frow = torch.div(hy - offset_xy[..., 1, None], res) - 0.5
    return frow, fcol


# Beams [..., B] with one pose [..., 3] and offset [..., 2] per leading
# index (none for a single scan); a batch of N candidates may share a
# stack of maps through ``map_index`` (see _bilinear_values).


def cost(prob, observed, ranges, angles, mask, sensor_pose, resolution,
         offset_xy, map_index=None):
    """Total squared-error cost over valid beams (f32 ``[...]``)."""
    hx, hy = _hit_points(sensor_pose, ranges, angles)
    frow, fcol = _frac_indices(hx, hy, resolution, offset_xy)
    value, _, _ = _interp_and_grad(prob, observed, frow, fcol, map_index)
    err = torch.where(mask, 1.0 - value, 0.0)
    return devmath.sum(err * err, dim=-1)


def hessian_and_residual(prob, observed, ranges, angles, mask, sensor_pose,
                         resolution, offset_xy, map_index=None):
    """(H [..., 3, 3], b [..., 3], cost [...]) at the given map-local
    sensor pose."""
    hx, hy = _hit_points(sensor_pose, ranges, angles)
    frow, fcol = _frac_indices(hx, hy, resolution, offset_xy)
    value, gx, gy = _interp_and_grad(prob, observed, frow, fcol, map_index)
    inv_res = 1.0 / resolution
    gx = gx * inv_res
    gy = gy * inv_res
    rx = hx - sensor_pose[..., 0, None]
    ry = hy - sensor_pose[..., 1, None]
    gt = -ry * gx + rx * gy
    # H = J^T W J, b = J^T W r and c = r^T W r as ONE product of
    # K = [J | r] ([..., B, 4]): [[H, b], [b^T, c]] = (W K)^T K.
    K = torch.stack([gx, gy, gt, 1.0 - value], dim=-1)
    M = devmath.matmul((K * mask[..., None]).transpose(-1, -2), K)
    return M[..., :3, :3], M[..., :3, 3], M[..., 3, 3]


def covariance(prob, observed, ranges, angles, mask, sensor_pose, resolution,
               offset_xy, scale=1e4, map_index=None):
    """Pose covariance = scale * H^{-1} (map-local frame)."""
    H, _, _ = hessian_and_residual(
        prob, observed, ranges, angles, mask, sensor_pose, resolution,
        offset_xy, map_index,
    )
    return devmath.inv(H) * scale


def _gn_loop(prob, observed, ranges, angles, mask, sensor_pose0, resolution,
             offset_xy, max_iterations, convergence_threshold,
             initial_lambda):
    """:func:`gn_refine`'s loop; returns (pose, cost, n_iterations, H),
    H evaluated at the returned pose."""

    def eval_at(p):
        return hessian_and_residual(
            prob, observed, ranges, angles, mask, p, resolution, offset_xy
        )

    dev = sensor_pose0.device
    H, b, cur = eval_at(sensor_pose0)
    p = sensor_pose0
    lam = f32(initial_lambda, dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    for _ in range(max_iterations):
        step = devmath.solve(H + lam * eye, b)
        p_new = p + step
        H_new, b_new, c_new = eval_at(p_new)
        accept = c_new < cur
        it_new = it + 1
        stop = (it_new >= max_iterations) | (
            accept & (torch.abs(cur - c_new) < convergence_threshold)
        )
        live = ~done
        take = live & accept
        p = torch.where(take, p_new, p)
        cur = torch.where(take, c_new, cur)
        H = torch.where(take, H_new, H)
        b = torch.where(take, b_new, b)
        lam = torch.where(
            live,
            torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                        torch.clamp(lam * 4.0, max=1e6)),
            lam,
        )
        it = torch.where(live, it_new, it)
        done = done | stop
    return p, cur, it, H


def gn_refine(prob, observed, ranges, angles, mask, sensor_pose0, resolution,
              offset_xy, max_iterations=10, convergence_threshold=1e-4,
              initial_lambda=1e-4):
    """Damped Gauss-Newton (Levenberg-Marquardt) refinement
    (``ScanMatcherLinearSolver::OptimizePose``), rejecting steps that
    increase the cost.  Returns (pose, cost, n_iterations) as device
    tensors.

    Runs ``max_iterations`` masked steps: once the stop test holds, the
    state stops changing, exactly as the JAX ``while_loop`` exits.  A
    singular system yields a non-finite step (``devmath.solve``), rejected
    like any cost increase, instead of a host-side check."""
    p, cur, it, _ = _gn_loop(
        prob, observed, ranges, angles, mask, sensor_pose0, resolution,
        offset_xy, max_iterations, convergence_threshold, initial_lambda,
    )
    return p, cur, it


def refine_plain(prob, observed, ranges, angles, mask, sensor_pose0,
                 resolution, offset_xy, max_iterations=10,
                 convergence_threshold=1e-4, initial_lambda=1e-4,
                 covariance_scale=1e4):
    """:func:`refine`'s plain version, on any device: :func:`cost` at the
    start, :func:`gn_refine`'s loop, and the covariance from the H the
    loop kept (what ``covariance(pose)`` evaluates again)."""
    cost0 = cost(prob, observed, ranges, angles, mask, sensor_pose0,
                 resolution, offset_xy)
    p, cur, it, H = _gn_loop(
        prob, observed, ranges, angles, mask, sensor_pose0, resolution,
        offset_xy, max_iterations, convergence_threshold, initial_lambda,
    )
    return p, cur, it, devmath.inv(H) * covariance_scale, cost0


def refine(prob, observed, ranges, angles, mask, sensor_pose0, resolution,
           offset_xy, max_iterations=10, convergence_threshold=1e-4,
           initial_lambda=1e-4, covariance_scale=1e4):
    """One match's refinement: ``(pose, cost, n_iterations, cov,
    initial cost)`` as device tensors, the values of :func:`gn_refine`,
    :func:`covariance` at the refined pose and :func:`cost` at
    ``sensor_pose0``, for one raster ``[H, W]`` and one scan ``[B]``.

    On the CPU :func:`refine_plain`.  On CUDA one launch of the kernel
    (``ops/gauss_newton_cuda.py``), which gives the same bits, or an
    error: there is no fallback to the plain version."""
    kw = dict(max_iterations=max_iterations,
              convergence_threshold=convergence_threshold,
              initial_lambda=initial_lambda,
              covariance_scale=covariance_scale)
    if prob.device.type == "cpu":
        return refine_plain(prob, observed, ranges, angles, mask,
                            sensor_pose0, resolution, offset_xy, **kw)
    return gauss_newton_cuda.refine(
        *(a.contiguous() for a in (prob, observed, ranges, angles, mask,
                                   sensor_pose0)),
        resolution, offset_xy.contiguous(), **kw)
