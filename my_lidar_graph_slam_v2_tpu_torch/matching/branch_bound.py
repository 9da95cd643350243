"""Branch-and-bound scan matcher (bound-ordered block descent).

Port of ``my_lidar_graph_slam_v2_tpu/matching/branch_bound.py``
(``scan_matcher_branch_bound.cpp:111-278``).  One match:

1. hit images of every (theta, beam) pair, built once
   (``ops/csm.py:build_hit_images``; the CUDA kernel on the card);
2. a strided sweep of the level-h max pyramid scores every 2^h-cell
   block across all thetas; each block's max over the gated thetas is an
   admissible upper bound on every leaf inside it;
3. blocks in descending-bound order, each fine-swept (all thetas, 2^h x
   2^h offsets) until the next bound cannot beat the running best or the
   score threshold: the reference's prune rule, so the winner is the same
   gated argmax a dense sweep finds.

The JAX package runs step 3 as a ``lax.while_loop`` inside one program.
Here it is a host loop: the bounds, the order and the threshold come back
in one fetch, then each swept block costs one fetch of the running best
sum (the loop's stop test); the winner's indices stay on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import pose as P
from ..ops import csm, pool
from ..utils.transfer import fetch, to_device
from .cost import CostConfig, cost_at, covariance_at
from .types import (
    ScanMatchingQuery,
    ScanMatchingSummary,
)


@dataclass(frozen=True)
class BranchBoundConfig:
    """Field for field the JAX package's ``BranchBoundConfig``."""

    node_height_max: int = 6
    range_x: float = 2.5
    range_y: float = 2.5
    range_theta: float = 0.5
    resolution: float = 0.05
    n_theta_max: int = 208
    crop_rows: int = 448
    crop_cols: int = 448
    covariance_scale: float = 1e4
    precision: str = "split"
    cost: CostConfig = None

    @property
    def win_cells(self):
        wx = int(math.ceil(0.5 * self.range_x / self.resolution))
        wy = int(math.ceil(0.5 * self.range_y / self.resolution))
        return wx, wy

    @property
    def bound_height(self):
        """Pyramid level of the pruning bounds (8-cell blocks at most)."""
        return max(1, min(self.node_height_max, 3))

    @property
    def blocks(self):
        wx, wy = self.win_cells
        step = 1 << self.bound_height
        return (2 * wx) // step + 1, (2 * wy) // step + 1


def branch_bound_core(cfg: BranchBoundConfig, prob, observed, pyr_p, pyr_o,
                      ranges, angles, mask, sensor_pose, offset_xy,
                      score_threshold, known_rate_threshold):
    """Port of ``_branch_bound_core``: returns ``(pose, score, found, cost
    / n, cov)`` as device tensors and ``stats`` (blocks swept: each one
    host fetch, after the bound order's).  u8 or f32 maps: the bound and block sweeps are
    ``ops/csm.py:sweep_from_hits`` at the configured precision (f32 on a
    u8 window, f64 on an f32 one, exact either way)."""
    csm.check_precision(cfg.precision)
    dev = prob.device
    wx, wy = cfg.win_cells
    nbx, nby = cfg.blocks
    block = 1 << cfg.bound_height
    T = cfg.n_theta_max

    step_theta, theta0, theta_mask = csm.theta_search_params(
        ranges, mask, cfg.resolution, cfg.range_theta, T
    )
    n_valid = torch.clamp(mask.sum().to(torch.float32), min=1.0)
    norm = 1.0 / n_valid

    # Shared hit images: one build for the bound sweep and every block.
    hr, hc, valid, r0, c0 = csm.beam_cells(
        ranges, angles, mask, sensor_pose, theta0, step_theta, theta_mask,
        cfg.resolution, offset_xy,
        n_theta=T, crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols,
    )
    hit_img = csm.build_hit_images(
        hr, hc, valid, theta_mask,
        crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols,
    )
    x0, y0 = -wx, -wy

    # 1. admissible block bounds from the level-h pyramid, known-rate gated
    c_scores, c_known = csm.sweep_from_hits(
        hit_img, r0, c0, pyr_p, pyr_o, x0, y0,
        nx=nbx, ny=nby, stride=block, precision=cfg.precision,
    )
    known_ok = c_known * norm > known_rate_threshold
    bound = torch.where(
        theta_mask[:, None, None] & known_ok, c_scores, -math.inf
    ).amax(dim=0).reshape(-1)

    # 2. blocks in descending-bound order (jnp.argsort is stable)
    order = torch.argsort(-bound, stable=True)
    thr_sum = score_threshold * n_valid  # the gates compare score sums
    bound_h, order_h, thr_h = fetch((bound, order, thr_sum))

    # 3. fine-sweep blocks until the next bound cannot win
    best_h = -math.inf
    best_sum = torch.full((), -math.inf, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    bt, bx, by = zero, zero, zero
    n_blocks = nby * nbx
    i = 0
    while i < n_blocks and bound_h[int(order_h[i])] > max(best_h, float(thr_h)):
        bj, bi = divmod(int(order_h[i]), nbx)
        fs, fk = csm.sweep_from_hits(
            hit_img, r0, c0, prob, observed, x0 + bi * block, y0 + bj * block,
            nx=block, ny=block, stride=1, precision=cfg.precision,
        )  # [T, block(y), block(x)]
        elig = theta_mask[:, None, None] & (fk * norm > known_rate_threshold)
        # winner flattened in [t, x, y] order, first index on ties
        flat = torch.where(elig, fs, -math.inf).transpose(1, 2).reshape(-1)
        a = torch.argmax(flat)
        s = flat.gather(0, a.reshape(1)).squeeze(0)
        better = s > best_sum
        best_sum = torch.where(better, s, best_sum)
        bt = torch.where(better, a // (block * block), bt)
        bx = torch.where(better, bi * block + (a // block) % block, bx)
        by = torch.where(better, bj * block + a % block, by)
        (best_h,) = fetch((best_sum,))
        best_h = float(best_h)
        i += 1

    best_score = best_sum * norm
    pose_found = best_score > score_threshold
    # The reference defaults the offsets to 0 when nothing clears the gates
    bx = torch.where(pose_found, bx - wx, 0)
    by = torch.where(pose_found, by - wy, 0)
    btt = torch.where(pose_found, theta0 + bt, 0)
    best_sensor_pose = torch.stack([
        sensor_pose[0] + bx.to(torch.float32) * cfg.resolution,
        sensor_pose[1] + by.to(torch.float32) * cfg.resolution,
        sensor_pose[2] + btt.to(torch.float32) * step_theta,
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
    return ((best_sensor_pose, best_score, pose_found, ncost, cov),
            dict(blocks_swept=i))


class ScanMatcherBranchBound:
    """Host wrapper holding the static config, the device and counters:
    ``matches`` and ``blocks_swept`` (a match fetches once per swept
    block and twice besides)."""

    def __init__(self, cfg: BranchBoundConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.matches = 0
        self.blocks_swept = 0

    def pyramid_of(self, grid_map):
        """Level-``bound_height`` pyramid maps, cached on the raster's
        ``coarse`` dict, which the map cache keeps per (map id, version):
        a finished map is pooled once however often it is matched."""
        key = ("pyr", self.cfg.bound_height)
        if key not in grid_map.coarse:
            grid_map.coarse[key] = (
                pool.pyramid(grid_map.prob, self.cfg.bound_height)[-1],
                pool.pyramid(grid_map.observed, self.cfg.bound_height)[-1],
            )
        return grid_map.coarse[key]

    def optimize_pose(self, query: ScanMatchingQuery,
                      score_threshold: float = 0.0,
                      known_rate_threshold: float = 0.0) -> ScanMatchingSummary:
        gm, scan = query.grid_map, query.scan
        sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
        pyr_p, pyr_o = self.pyramid_of(gm)
        out, stats = branch_bound_core(
            self.cfg, gm.prob, gm.observed, pyr_p, pyr_o,
            scan.ranges, scan.angles, scan.mask,
            to_device(sensor_pose, self.device, np.float32),
            to_device(gm.offset_xy, self.device, np.float32),
            float(np.float32(score_threshold)),
            float(np.float32(known_rate_threshold)),
        )
        pose_s, score, found, ncost, cov = fetch(out)
        self.matches += 1
        self.blocks_swept += stats["blocks_swept"]
        est = P.move_backward(pose_s, scan.rel_sensor_pose)
        return ScanMatchingSummary(
            pose_found=bool(found),
            normalized_cost=float(ncost),
            initial_pose=np.asarray(query.initial_pose),
            estimated_pose=est,
            covariance=cov,
            normalized_score=float(score),
        )
