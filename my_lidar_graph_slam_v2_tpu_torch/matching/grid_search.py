"""Exhaustive grid-search scan matcher.

Port of ``my_lidar_graph_slam_v2_tpu/matching/grid_search.py``
(``mapping/scan_matcher_grid_search.cpp:84-178``): every (x, y, theta) of
the configured ranges and steps is scored pixel-accurately, gated on its
score and known rate, and the first maximum in the reference's (theta,
x, y) order wins.

Steps equal to the map resolution make every translation an integer cell
shift: the whole grid is one ``ops/csm.py:sweep`` call, one stride-1 tile
of (2 wy + 1) x (2 wx + 1) offsets over all 2 wt + 1 thetas (on the card
one launch of ``csrc/csm_sweep.cu``).  Any other step moves each beam's
floor cell by a fraction, so :func:`pixel_scores_gather` scores each
candidate by a direct per-beam gather.  On u8 maps both sum levels as
integers, one multiply by f32(1/255) at the end (the sweep at any
precision but ``"highest"``; its sums equal the JAX package's bit for
bit).  The sweep on f32 maps or at ``"highest"`` takes the f32 window
rounded at the configured precision, the gather f32 maps' values with no
precision's rounding (the JAX gather ignores the precision); both round
the values to multiples of 2^-41 (``ops/csm.py:round_to_fixed_point``,
which changes no value from 2^-18 up), sum in f64 and round to f32 once,
exactly, on either device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import pose as P
from ..ops import csm, quant
from ..utils import devmath
from ..utils.transfer import f32, fetch, to_device
from .cost import CostConfig, cost_at, covariance_at
from .types import ScanMatchingQuery, ScanMatchingSummary


@dataclass(frozen=True)
class GridSearchConfig:
    """Field for field the JAX package's ``GridSearchConfig``."""

    range_x: float = 2.5
    range_y: float = 2.5
    range_theta: float = 0.5
    step_x: float = 0.05
    step_y: float = 0.05
    step_theta: float = 0.005
    resolution: float = 0.05
    crop_rows: int = 448
    crop_cols: int = 448
    covariance_scale: float = 1e4
    precision: str = "split"
    cost: CostConfig = None

    @property
    def integer_steps(self) -> bool:
        """Steps equal to the map resolution take the sweep."""
        return (
            abs(self.step_x - self.resolution) <= 1e-9
            and abs(self.step_y - self.resolution) <= 1e-9
        )

    @property
    def wins(self):
        wx = int(math.ceil(0.5 * self.range_x / self.step_x))
        wy = int(math.ceil(0.5 * self.range_y / self.step_y))
        wt = int(math.ceil(0.5 * self.range_theta / self.step_theta))
        return wx, wy, wt


# Gather elements per theta chunk of pixel_scores_gather (bounds its
# [chunk, nx, ny, B] index tensors to a few hundred MB).
_GATHER_CHUNK = 1 << 24


def sweep_scores(cfg: GridSearchConfig, prob, observed, ranges, angles, mask,
                 sensor_pose, offset_xy):
    """Integer steps: (scores, known) f32 ``[T, ny, nx]`` from one sweep
    of one (2 wy + 1) x (2 wx + 1) stride-1 tile, the window's origin at
    (-wx, -wy) cells from the crop anchor, all thetas valid: the JAX
    package's ``csm_sweep`` call at ``grid_search.py:124-131``."""
    wx, wy, wt = cfg.wins
    T = 2 * wt + 1
    dev = prob.device
    return csm.csm_sweep(
        prob, observed, ranges, angles, mask, sensor_pose,
        torch.full((), -wt, dtype=torch.int32, device=dev),
        f32(cfg.step_theta, dev), torch.ones(T, dtype=torch.bool, device=dev),
        -wx, -wy, cfg.resolution, offset_xy, n_theta=T, nx=2 * wx + 1,
        ny=2 * wy + 1, stride=1, crop_rows=cfg.crop_rows,
        crop_cols=cfg.crop_cols, precision=cfg.precision,
    )


def pixel_scores_gather(cfg: GridSearchConfig, prob, observed, ranges, angles,
                        mask, sensor_pose, offset_xy):
    """Arbitrary steps: (scores, known) f32 ``[T, ny, nx]``, each
    candidate's beams projected at its own fractional offset and read from
    the whole map (no crop; cells off the map read 0) — the JAX package's
    ``_pixel_scores_gather``.  u8 levels are summed in int32 and scaled
    once by f32(1/255), f32 values rounded by
    ``ops/csm.py:round_to_fixed_point``, summed in f64 (exactly) and
    rounded once; known is the count of observed cells."""
    wx, wy, wt = cfg.wins
    T, nx, ny = 2 * wt + 1, 2 * wx + 1, 2 * wy + 1
    dev = prob.device
    h, w = prob.shape
    res = f32(cfg.resolution, dev)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)  # noqa: E731
    dx = (ar(nx) - wx) * cfg.step_x
    dy = (ar(ny) - wy) * cfg.step_y
    thetas = sensor_pose[2] + (ar(T) - wt) * cfg.step_theta
    u8 = prob.dtype == torch.uint8
    acc = torch.int32 if u8 else torch.float64
    zero = torch.zeros(1, dtype=acc, device=dev)
    levels = torch.cat([csm.round_to_fixed_point(prob).reshape(-1).to(acc),
                        zero])
    seen = torch.cat([observed.reshape(-1).to(torch.int32), zero.int()])
    B = ranges.shape[0]
    step = max(1, _GATHER_CHUNK // (nx * ny * B))
    s_parts, k_parts = [], []
    for t0 in range(0, T, step):
        ang = thetas[t0:t0 + step, None] + angles  # [tc, B]
        hx = sensor_pose[0] + ranges * devmath.cos(ang)
        hy = sensor_pose[1] + ranges * devmath.sin(ang)
        cx = torch.floor(torch.div(
            hx[:, None, None, :] + dx[:, None, None] - offset_xy[0], res
        )).to(torch.int32)  # [tc, nx, 1, B]
        cy = torch.floor(torch.div(
            hy[:, None, None, :] + dy[:, None] - offset_xy[1], res
        )).to(torch.int32)  # [tc, 1, ny, B]
        ok = mask & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        idx = torch.where(ok, cy.long() * w + cx.long(), h * w)
        s_parts.append(levels[idx].sum(-1, dtype=acc))
        k_parts.append(seen[idx].sum(-1, dtype=torch.int32))
    scores = torch.cat(s_parts).to(torch.float32)
    if u8:
        scores = scores * float(quant.INV255)
    known = torch.cat(k_parts).to(torch.float32)
    return scores.transpose(1, 2), known.transpose(1, 2)


def grid_search_core(cfg: GridSearchConfig, prob, observed, ranges, angles,
                     mask, sensor_pose, offset_xy, score_threshold,
                     known_rate_threshold):
    """Port of ``_grid_search_core``: (pose, score, found, cost / n, cov)
    as device tensors, for one scan ``[B]`` on one u8 or f32 raster ``[H,
    W]``."""
    csm.check_precision(cfg.precision)
    wx, wy, wt = cfg.wins
    nx, ny = 2 * wx + 1, 2 * wy + 1
    dev = prob.device
    n_valid = torch.clamp(mask.sum().to(torch.float32), min=1.0)
    norm = torch.div(f32(1.0, dev), n_valid)
    core = sweep_scores if cfg.integer_steps else pixel_scores_gather
    scores, known = core(cfg, prob, observed, ranges, angles, mask,
                         sensor_pose, offset_xy)
    eligible = (scores * norm > score_threshold) & (
        known * norm > known_rate_threshold
    )
    # Reference iteration order: t outer, then x, then y; first max wins
    # (torch.argmax returns the first maximum on every device).
    flat = torch.where(eligible, scores, -math.inf).transpose(1, 2).reshape(-1)
    best = flat.argmax()
    best_sum = flat[best]
    bt = best // (nx * ny)
    bx = (best // ny) % nx
    by = best % ny
    best_score = best_sum * norm
    pose_found = best_score > score_threshold
    best_sensor_pose = torch.stack([
        sensor_pose[0] + (bx.to(torch.float32) - wx) * cfg.step_x,
        sensor_pose[1] + (by.to(torch.float32) - wy) * cfg.step_y,
        sensor_pose[2] + (bt.to(torch.float32) - wt) * cfg.step_theta,
    ])
    ccfg = cfg.cost or CostConfig(covariance_scale=cfg.covariance_scale)
    ncost = cost_at(
        ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
        cfg.resolution, offset_xy,
    ) * norm
    cov = covariance_at(
        ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
        cfg.resolution, offset_xy,
    )
    return best_sensor_pose, best_score, pose_found, ncost, cov


class ScanMatcherGridSearch:
    """Host wrapper holding the static config, the device and counters:
    ``matches`` and ``host_fetches`` (one per match)."""

    def __init__(self, cfg: GridSearchConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.matches = 0
        self.host_fetches = 0

    def optimize_pose(self, query: ScanMatchingQuery,
                      score_threshold: float = 0.0,
                      known_rate_threshold: float = 0.0) -> ScanMatchingSummary:
        gm, scan = query.grid_map, query.scan
        sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
        pose_s, score, found, ncost, cov = fetch(grid_search_core(
            self.cfg, gm.prob, gm.observed, scan.ranges, scan.angles,
            scan.mask, to_device(sensor_pose, self.device, np.float32),
            to_device(gm.offset_xy, self.device, np.float32),
            float(np.float32(score_threshold)),
            float(np.float32(known_rate_threshold)),
        ))
        self.matches += 1
        self.host_fetches += 1
        return ScanMatchingSummary(
            pose_found=bool(found),
            normalized_cost=float(ncost),
            initial_pose=np.asarray(query.initial_pose),
            estimated_pose=P.move_backward(pose_s, scan.rel_sensor_pose),
            covariance=cov,
            normalized_score=float(score),
        )
