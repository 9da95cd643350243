"""Greedy-endpoint (GMapping-style) cost function.

Port of ``my_lidar_graph_slam_v2_tpu/ops/greedy_endpoint.py``
(``mapping/cost_function_greedy_endpoint.cpp``): for each beam, a hit
point and a point pulled back by ``hit_and_missed_dist`` are projected to
cells; a (2K+1)^2 kernel window around both is searched for the offset of
least Gaussian cost whose hit cell is occupied and whose missed cell is
free; unknown cells are skipped; a beam with no admissible offset takes
the default (worst) cost.  The covariance is the reference's numeric
gradient ``g g^T + 0.1 I`` (lines 105-162).

The occupancy gate reads the map as the JAX module does: on an f32 map
it compares probabilities with the threshold; on a u8 map it compares the
raw u8 levels, as f32, with the same threshold, so every non-zero level
counts as "occupied" and only level 0 as "free" (ROADMAP 3.9 and 3.10:
gating the dequantized probabilities instead lets the HillClimbing
frontend drift ten times further than odometry).

Poses ``[..., 3]`` and offsets ``[..., 2]`` may carry leading axes, one
cost per pose (hill climbing scores its 6 moves in one call), with one
scan ``[B]`` or one per pose ``[..., B]``; a stack of maps ``[M, H, W]``
takes ``map_index`` (i64 ``[N]``), as in ``ops/gauss_newton.py``.

The per-beam costs are sums of table values: at the default kernel size 1
the 10 values (9 table entries and the default) lie in [0.018, 1] in
magnitude, so the f64 sum of up to 2048 of them is exact in any order and
the cost, rounded once to f32, is the same on every device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import devmath
from ..utils.transfer import f32, to_device


def make_kernel_tables(kernel_size: int, resolution: float, std_dev: float,
                       device):
    """(offset x i32 ``[K]``, offset y i32 ``[K]``, cost f32 ``[K]``,
    default cost f32 0-d) on ``device``, K = (2 kernel_size + 1)^2, in
    the JAX module's order and values."""
    k = kernel_size
    offs = np.arange(-k, k + 1)
    ox, oy = np.meshgrid(offs, offs, indexing="xy")
    sqd = (resolution * ox) ** 2 + (resolution * oy) ** 2
    var = std_dev * std_dev
    table = -np.exp(-0.5 * sqd / var)
    max_d = (resolution * (k + 1)) ** 2 * 2
    default = -np.exp(-0.5 * max_d / var)
    return (
        to_device(ox.reshape(-1), device, np.int32),
        to_device(oy.reshape(-1), device, np.int32),
        to_device(table.reshape(-1), device, np.float32),
        to_device(default, device, np.float32),
    )


def _cells(px, py, resolution, offset_xy):
    res = f32(resolution, px.device)
    c = torch.floor(torch.div(px - offset_xy[..., 0, None], res))
    r = torch.floor(torch.div(py - offset_xy[..., 1, None], res))
    return r.to(torch.int32), c.to(torch.int32)


def cost(prob, observed, ranges, angles, mask, sensor_pose, resolution,
         offset_xy, map_index=None, *, kernel_ox, kernel_oy, kernel_cost,
         default_cost, hit_and_missed_dist=0.075, occupancy_threshold=0.1,
         scaling_factor=1.0):
    """Total greedy-endpoint cost over valid beams, f32 ``[...]`` for
    poses ``[..., 3]``."""
    H, W = prob.shape[-2:]
    ang = sensor_pose[..., 2, None] + angles
    ca, sa = devmath.cos(ang), devmath.sin(ang)
    x0 = sensor_pose[..., 0, None]
    y0 = sensor_pose[..., 1, None]
    pulled = ranges - hit_and_missed_dist
    hr, hc = _cells(x0 + ranges * ca, y0 + ranges * sa, resolution, offset_xy)
    mr, mc = _cells(x0 + pulled * ca, y0 + pulled * sa, resolution, offset_xy)
    # u8 levels or f32 probabilities, gated against the same threshold
    probf = prob.reshape(-1).to(torch.float32)
    obs = observed.reshape(-1)

    def read(r, c):  # cells [..., B, K] -> (prob, 0 where unknown; known)
        inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        idx = (torch.clamp(r, 0, H - 1).long() * W
               + torch.clamp(c, 0, W - 1).long())
        if map_index is not None:
            idx = idx + map_index.reshape(-1, *(1,) * (idx.ndim - 1)) * (H * W)
        known = obs[idx] & inside
        return torch.where(known, probf[idx], 0.0), known

    hp, hknown = read(hr[..., None] + kernel_oy, hc[..., None] + kernel_ox)
    mp, mknown = read(mr[..., None] + kernel_oy, mc[..., None] + kernel_ox)
    thr = float(np.float32(occupancy_threshold))
    admissible = hknown & mknown & (hp >= thr) & (mp <= thr)
    costs = torch.where(admissible, kernel_cost, math.inf)
    per_beam = torch.minimum(costs.amin(dim=-1), default_cost)
    total = devmath.sum(torch.where(mask, per_beam, 0.0), dim=-1)
    return total * scaling_factor


def gradient_and_covariance(cost_fn, sensor_pose, resolution):
    """Numeric gradient ``[..., 3]`` and ``g g^T + 0.1 I`` ``[..., 3, 3]``
    (reference lines 105-162): central differences of f32 poses with f32
    steps (the resolution in x and y, 0.01 rad in theta), the six
    perturbed poses scored in one ``cost_fn`` call (poses ``[..., 6, 3]``
    -> costs ``[..., 6]``)."""
    dev = sensor_pose.device
    d = np.array([resolution, resolution, 1e-2])
    steps = to_device(np.diag(d), dev, np.float32)
    p = sensor_pose[..., None, :]
    c = cost_fn(torch.cat([p + steps, p - steps], dim=-2))
    g = torch.div(c[..., :3] - c[..., 3:], to_device(2 * d, dev, np.float32))
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    cov = g[..., :, None] * g[..., None, :] + 0.1 * eye
    return g, cov
