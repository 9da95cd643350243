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

:class:`BranchBoundBatch` is the same search over a batch of N candidates
(a backend step's, ``parallel/loop_sharded.py``): one hit-image build and
one bound sweep for all, one fetch of their bounds, then a descent in
lockstep rounds.  A round sweeps every live candidate's next blocks in
bound order, at most ``round_blocks`` each, in one call, and fetches
their maxima once; the host then replays the serial stop rule over them,
so the winner and the blocks swept are :func:`branch_bound_core`'s, bit
for bit, whatever ``round_blocks`` is.  Blocks swept past a candidate's
stop cost device time only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core import pose as P
from ..metrics.registry import MetricManager
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


def pyramid_of(grid_map, height: int):
    """Level-``height`` pyramid maps of a raster, cached on its ``coarse``
    dict, which the map cache keeps per (map id, version): a finished map
    is pooled once however often it is matched."""
    key = ("pyr", height)
    if key not in grid_map.coarse:
        grid_map.coarse[key] = (
            pool.pyramid(grid_map.prob, height)[-1],
            pool.pyramid(grid_map.observed, height)[-1],
        )
    return grid_map.coarse[key]


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
        """:func:`pyramid_of` at this matcher's bound height."""
        return pyramid_of(grid_map, self.cfg.bound_height)

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


# Blocks a candidate sweeps per round of the batched descent at most
# (PERF.md says why this many).
ROUND_BLOCKS = 4


class BranchBoundBatch:
    """:func:`branch_bound_core` over N candidates, run in phases that a
    host loop runs in lockstep (:func:`descend`).  The constructor
    launches the common part: theta windows, beam cells, the hit images of
    all N (one :func:`ops.csm.build_hit_images_batch` call), the bound
    sweeps (one :func:`ops.csm.sweep_from_hits_batch` call) and each
    candidate's block order; ``to_fetch`` holds what the host reads of
    it.

    The maps are one raster ``[H, W]`` with its pyramid level, or a stack
    ``[M, H, W]`` of each with ``map_index`` (i64 ``[N]``) naming each
    candidate's; beams ``[N, B]``, sensor poses ``[N, 3]`` and map
    offsets ``[N, 2]`` on the maps' device.  The thresholds are Python
    floats, f32 values as :func:`branch_bound_core` takes them."""

    def __init__(self, cfg: BranchBoundConfig, prob, observed, pyr_p, pyr_o,
                 ranges, angles, mask, sensor_pose, offset_xy,
                 score_threshold, known_rate_threshold, *, map_index=None):
        csm.check_precision(cfg.precision)
        self.cfg = cfg
        self.maps = (prob, observed)
        self.map_index = map_index
        self.score_threshold = score_threshold
        self.known_rate_threshold = known_rate_threshold
        dev = prob.device
        n = ranges.shape[0]
        wx, wy = cfg.win_cells
        nbx, nby = cfg.blocks
        block = 1 << cfg.bound_height
        T = cfg.n_theta_max

        step_theta, theta0, theta_mask = csm.theta_search_params(
            ranges, mask, cfg.resolution, cfg.range_theta, T)
        n_valid = torch.clamp(mask.sum(-1).to(torch.float32), min=1.0)
        norm = 1.0 / n_valid
        hr, hc, valid, r0, c0 = csm.beam_cells(
            ranges, angles, mask, sensor_pose, theta0, step_theta, theta_mask,
            cfg.resolution, offset_xy,
            n_theta=T, crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols,
        )
        self.hits = csm.build_hit_images_batch(
            hr, hc, valid, theta_mask, r0, c0,
            crop_rows=cfg.crop_rows, crop_cols=cfg.crop_cols)

        # 1. admissible block bounds from the level-h pyramid, known-rate
        # gated, and each candidate's blocks in descending-bound order
        c_scores, c_known = csm.sweep_from_hits_batch(
            self.hits, pyr_p, pyr_o,
            torch.full((n,), -wx, dtype=torch.int32, device=dev),
            torch.full((n,), -wy, dtype=torch.int32, device=dev),
            nx=nbx, ny=nby, stride=block, precision=cfg.precision,
            cand=list(range(n)), map_index=map_index)
        known_ok = c_known * norm[:, None, None, None] > known_rate_threshold
        bound = torch.where(
            theta_mask[:, :, None, None] & known_ok, c_scores, -math.inf
        ).amax(dim=1).reshape(n, -1)
        self.order = torch.argsort(-bound, dim=1, stable=True)
        self.theta_mask, self.norm = theta_mask, norm
        self.to_fetch = (bound, self.order, score_threshold * n_valid, norm,
                         step_theta, theta0, sensor_pose)

    def take_bounds(self, host):
        """Take the host copy of ``to_fetch``; every candidate starts live
        at its first block, with no best yet."""
        (self.bound_h, order, self.thr_h, self.norm_h, self.step_h,
         self.theta0_h, self.pose_h) = host
        self.order_h = order.astype(np.int64)
        n = len(self.thr_h)
        self.pos = [0] * n
        self.best = [-math.inf] * n
        self.winner = [(0, 0, 0)] * n
        self.live = list(range(n))
        self.planned = []
        self.speculative = 0

    def _may_win(self, c, i, best):
        """Whether candidate ``c``'s ``i``-th block in bound order is due
        under the serial stop rule at running best ``best``."""
        return (i < len(self.order_h[c])
                and self.bound_h[c, self.order_h[c, i]]
                > max(best, float(self.thr_h[c])))

    def plan(self, round_blocks: int) -> bool:
        """Choose the next round's blocks, host only: each live
        candidate's next blocks in bound order, at most ``round_blocks``,
        whose bound beats its best and threshold now (the best only rises,
        so no later block can); a candidate with none is done.  Returns
        whether there is anything to sweep."""
        self.planned = []
        for c in self.live:
            k = 0
            while (k < round_blocks
                   and self._may_win(c, self.pos[c] + k, self.best[c])):
                k += 1
            if k:
                self.planned.append((c, self.pos[c], k))
        self.live = [c for c, _, _ in self.planned]
        return bool(self.planned)

    def launch(self):
        """Sweep the planned blocks in one call; returns the device tensors
        the host reads: per block, its best gated sum and where (``[t, x,
        y]``-flat, first index on ties), as the serial core takes them."""
        cfg = self.cfg
        wx, wy = cfg.win_cells
        nbx, _ = cfg.blocks
        block = 1 << cfg.bound_height
        dev = self.order.device
        blk = torch.cat([self.order[c, i:i + k] for c, i, k in self.planned])
        cand = [c for c, _, k in self.planned for _ in range(k)]
        idx = torch.cat([torch.full((k,), c, dtype=torch.int64, device=dev)
                         for c, _, k in self.planned])
        x0 = ((blk % nbx) * block - wx).to(torch.int32)
        y0 = ((blk // nbx) * block - wy).to(torch.int32)
        fs, fk = csm.sweep_from_hits_batch(
            self.hits, *self.maps, x0, y0, nx=block, ny=block, stride=1,
            precision=cfg.precision, cand=cand, map_index=self.map_index,
        )  # [P, T, block(y), block(x)]
        elig = self.theta_mask[idx][:, :, None, None] & (
            fk * self.norm[idx][:, None, None, None]
            > self.known_rate_threshold)
        flat = torch.where(elig, fs, -math.inf).transpose(2, 3).reshape(
            len(cand), -1)
        a = torch.argmax(flat, dim=1)
        return flat.gather(1, a[:, None]).squeeze(1), a

    def take_round(self, host):
        """Replay the serial stop rule over the round's swept blocks in
        order: a block counts while its bound beats the running best and
        the threshold, and a strictly larger sum takes the lead."""
        s_h, a_h = host
        cfg = self.cfg
        nbx, _ = cfg.blocks
        block = 1 << cfg.bound_height
        w, live = 0, []
        for c, i, k in self.planned:
            best, j = self.best[c], 0
            while j < k and self._may_win(c, i + j, best):
                if s_h[w + j] > best:
                    best = float(s_h[w + j])
                    a = int(a_h[w + j])
                    bj, bi = divmod(int(self.order_h[c, i + j]), nbx)
                    self.winner[c] = (a // (block * block),
                                      bi * block + (a // block) % block,
                                      bj * block + a % block)
                j += 1
            self.best[c], self.pos[c] = best, i + j
            self.speculative += k - j
            if j == k:
                live.append(c)
            w += k
        self.live = live

    def result(self):
        """Per candidate, host arrays: the sensor pose f32 ``[N, 3]``, the
        score f32 ``[N]`` and whether it clears the score gate, worked in
        f32 as :func:`branch_bound_core` works them on the device; and the
        blocks each swept."""
        f = np.float32
        cfg = self.cfg
        wx, wy = cfg.win_cells
        score = np.array(self.best, f) * self.norm_h.astype(f)
        found = score > f(self.score_threshold)
        bt, bx, by = np.array(self.winner, np.int64).reshape(-1, 3).T
        bx = np.where(found, bx - wx, 0)
        by = np.where(found, by - wy, 0)
        btt = np.where(found, self.theta0_h.astype(np.int64) + bt, 0)
        pose = self.pose_h.astype(f)
        res = f(cfg.resolution)
        sensor_pose = np.stack([
            pose[:, 0] + bx.astype(f) * res,
            pose[:, 1] + by.astype(f) * res,
            pose[:, 2] + btt.astype(f) * self.step_h.astype(f),
        ], axis=-1)
        return sensor_pose, score, found, list(self.pos)


def fetch_all(groups, device):
    """One host fetch of every tuple in ``groups`` (tensors on any device),
    split back into tuples of f64 arrays."""
    flat = [t.to(device) for g in groups for t in g]
    host, out = fetch(tuple(flat)), []
    for g in groups:
        out.append(host[:len(g)])
        host = host[len(g):]
    return out


def descend(start, device, round_blocks: int = ROUND_BLOCKS):
    """Run batches of :class:`BranchBoundBatch` to their ends in lockstep:
    ``start()`` launches them (a list, one per device); their bounds come
    back in one fetch (span ``bb.bound`` around both), then each round
    launches every batch's planned blocks and fetches them once (span
    ``bb.round``, inside ``bb.descend``).  Returns each batch's
    :meth:`BranchBoundBatch.result`.  Counters
    ``LoopDetector.BranchBound.Matches``, ``.BlocksSwept`` (the blocks the serial rule sweeps),
    ``.BlocksSpeculative`` (swept past a stop) and ``.Rounds``."""
    mm = MetricManager.instance()
    span, name = mm.span, "LoopDetector.BranchBound"
    with span("bb.bound"):
        batches = start()
        for b, h in zip(batches, fetch_all([b.to_fetch for b in batches],
                                           device)):
            b.take_bounds(h)
    with span("bb.descend"):
        while True:
            due = [b for b in batches if b.plan(round_blocks)]
            if not due:
                break
            with span("bb.round"):
                for b, h in zip(due, fetch_all([b.launch() for b in due],
                                               device)):
                    b.take_round(h)
            mm.counter(f"{name}.Rounds").increment()
    results = [b.result() for b in batches]
    for b, r in zip(batches, results):
        mm.counter(f"{name}.Matches").increment(len(r[3]))
        mm.counter(f"{name}.BlocksSwept").increment(sum(r[3]))
        mm.counter(f"{name}.BlocksSpeculative").increment(b.speculative)
    return results

