"""Real-time correlative scan matcher.

Port of ``my_lidar_graph_slam_v2_tpu/matching/correlative.py``
(``scan_matcher_correlative.cpp:116-368``): the whole pose window is
scored by a strided coarse sweep and a stride-1 fine sweep
(``ops/csm.py:sweep``, the CUDA kernel on the card), gated by the coarse
blocks, and the winner picked by a masked argmax with the reference's
(theta, x, y) tie-break.

Only the ``sweep_backend="matmul"`` branch is ported, on u8 maps; that is
every map the frontend matches against.  The top-K theta prune and the
top-B block prune are certified exactly as in the JAX package, and the
int8 multiplicity certificate is kept so ``exact`` (and with it the
dense re-runs) matches the reference.  Top-K uses a stable descending
sort: ``jax.lax.top_k`` puts the lower index first on ties, and coarse
bounds, multiples of 1/255, tie often.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core import pose as P
from ..metrics.registry import MetricManager
from ..ops import csm, pool
from ..utils.transfer import fetch, to_device
from .cost import CostConfig, cost_at, covariance_at
from .types import (
    MapRaster,
    ScanMatchingQuery,
    ScanMatchingSummary,
)


@dataclass(frozen=True)
class CorrelativeConfig:
    """Field for field the JAX package's ``CorrelativeConfig``."""

    low_resolution: int = 5
    range_x: float = 0.25
    range_y: float = 0.25
    range_theta: float = 0.5
    resolution: float = 0.05
    n_theta_max: int = 208
    crop_rows: int = 384
    crop_cols: int = 384
    covariance_scale: float = 1e4
    precision: str = "split"
    cost: CostConfig = None
    fine_theta_k: int = 32
    sweep_backend: str = "matmul"
    fine_block_b: int = 10
    coarse_int8: bool = True

    @property
    def win_cells(self):
        wx = int(math.ceil(0.5 * self.range_x / self.resolution))
        wy = int(math.ceil(0.5 * self.range_y / self.resolution))
        return wx, wy

    @property
    def blocks(self):
        wx, wy = self.win_cells
        nbx = (2 * wx) // self.low_resolution + 1
        nby = (2 * wy) // self.low_resolution + 1
        return nbx, nby


def _top(values, k):
    """(values, indices) of the k largest, lower index first on ties —
    the order of ``jax.lax.top_k``."""
    v, i = torch.sort(values, descending=True, stable=True)
    return v[:k], i[:k]


def _at(values, index):
    """``values[index]`` for a 0-d device index without a host sync
    (indexing with a 0-d tensor converts it to a Python int)."""
    return values.index_select(0, index.reshape(1)).squeeze(0)


def correlative_core(cfg: CorrelativeConfig, prob, observed, coarse_prob,
                     coarse_observed, ranges, angles, mask, sensor_pose,
                     offset_xy, score_threshold, known_rate_threshold, *,
                     dense: bool = False):
    """Port of ``_correlative_core``; returns the same 9-tuple of device
    tensors (pose, score, known, found, cost / n, cov, n_processed,
    n_total, exact)."""
    if cfg.sweep_backend != "matmul":
        raise NotImplementedError(
            "sweep_backend='gather' is not ported (ROADMAP item 1.7)"
        )
    if prob.dtype != torch.uint8 or cfg.precision == "highest":
        raise NotImplementedError(
            "the port's correlative core matches u8 maps with a non-"
            "'highest' precision only (ROADMAP item 1.4)"
        )
    dev = prob.device
    wx, wy = cfg.win_cells
    nbx, nby = cfg.blocks
    LR = cfg.low_resolution
    nxf, nyf = nbx * LR, nby * LR
    T = cfg.n_theta_max
    CR, CC = cfg.crop_rows, cfg.crop_cols

    step_theta, theta0, theta_mask = csm.theta_search_params(
        ranges, mask, cfg.resolution, cfg.range_theta, T
    )
    n_valid = mask.sum().to(torch.float32)
    norm = 1.0 / torch.clamp(n_valid, min=1.0)
    x0, y0 = -wx, -wy

    hr, hc, valid, r0, c0 = csm.beam_cells(
        ranges, angles, mask, sensor_pose, theta0, step_theta, theta_mask,
        cfg.resolution, offset_xy, n_theta=T, crop_rows=CR, crop_cols=CC,
    )
    ok_tb = valid & theta_mask[:, None]
    use_int8 = (not dense) and cfg.coarse_int8
    if use_int8:
        int8_ok = csm.max_hit_multiplicity(hr, hc, ok_tb, crop_cols=CC) <= 127

    # Coarse window: pooled over the crop only (pool-on-crop) unless the
    # caller holds full pooled maps.  Both give the same values.
    in_rows, in_cols = CR + (nby - 1) * LR, CC + (nbx - 1) * LR
    if coarse_prob is None:
        seg = csm.sweep_input_window(
            prob, observed, r0, c0, x0, y0,
            in_rows=in_rows + LR - 1, in_cols=in_cols + LR - 1,
        )
        pooled = pool.sliding_window_max2d(seg.permute(2, 0, 1), LR)
        coarse_inp = pooled.permute(1, 2, 0)[:in_rows, :in_cols]
    else:
        coarse_inp = csm.sweep_input_window(
            coarse_prob, coarse_observed, r0, c0, x0, y0,
            in_rows=in_rows, in_cols=in_cols,
        )
    origin = torch.zeros((1, 1, 2), dtype=torch.int32, device=dev)
    c = csm.sweep(
        coarse_inp.contiguous()[None], hr[None], hc[None], ok_tb[None],
        origin, tile_h=nby, tile_w=nbx, stride=LR,
    )[0]  # [T, 2, nby * nbx]
    c_scores = c[:, 0].reshape(T, nby, nbx)
    c_known = c[:, 1].reshape(T, nby, nbx)

    # Reference gating (scan_matcher_correlative.cpp:178-189)
    block_ok = (
        (c_scores * norm > score_threshold)
        & (c_known * norm > known_rate_threshold)
        & theta_mask[:, None, None]
    )

    use_topk = (not dense) and 0 < cfg.fine_theta_k < T
    if use_topk:
        K = cfg.fine_theta_k
        bound = torch.where(block_ok, c_scores, -math.inf).amax(dim=(1, 2))
        kth, sel_theta = _top(bound, K)
        kth_bound = kth[K - 1]
        ok_rows = block_ok[sel_theta]
    else:
        sel_theta = torch.arange(T, device=dev)
        ok_rows = block_ok

    n_blocks = nby * nbx
    use_blocks = (not dense) and 0 < cfg.fine_block_b < n_blocks
    if use_blocks:
        # Top-B coarse-block prune: sweep only the offsets of the B blocks
        # with the largest gated coarse bound, one LR x LR tile each.
        Bb = cfg.fine_block_b
        c_sel = c_scores[sel_theta] if use_topk else c_scores
        blk_bound = torch.where(ok_rows, c_sel, -math.inf).amax(dim=0)
        bvals, bidx = _top(blk_bound.reshape(-1), Bb + 1)
        blk_next_bound = bvals[Bb]
        bsel = bidx[:Bb]
        origins = torch.stack([bsel // nbx * LR, bsel % nbx * LR], dim=-1)
        tile_h = tile_w = LR
        elig_f = ok_rows.reshape(ok_rows.shape[0], -1)[:, bsel]
        elig_f = elig_f.repeat_interleave(LR * LR, dim=1)
    else:
        origins = torch.zeros((1, 2), dtype=torch.int64, device=dev)
        tile_h, tile_w = nyf, nxf
        elig_f = ok_rows.repeat_interleave(LR, dim=1).repeat_interleave(
            LR, dim=2
        ).reshape(ok_rows.shape[0], -1)
    # The sweep's offsets in its output order (tile-major, then j, then i).
    off = csm.tile_offsets(origins[None], tile_h=tile_h, tile_w=tile_w,
                           stride=1)[0]
    offs_y, offs_x = off[:, 0], off[:, 1]

    fine_inp = csm.sweep_input_window(
        prob, observed, r0, c0, x0, y0,
        in_rows=CR + nyf - 1, in_cols=CC + nxf - 1,
    )
    if use_topk:
        hr_s, hc_s, ok_s = hr[sel_theta], hc[sel_theta], ok_tb[sel_theta]
    else:
        hr_s, hc_s, ok_s = hr, hc, ok_tb
    f = csm.sweep(
        fine_inp[None], hr_s[None], hc_s[None], ok_s[None],
        origins.to(torch.int32)[None], tile_h=tile_h, tile_w=tile_w, stride=1,
    )[0]
    f_scores_f, f_known_f = f[:, 0], f[:, 1]  # [R, n_off]
    n_off = f_scores_f.shape[1]

    # Winner with the reference's (theta, x, y) loop-nesting tie-break.
    flat = torch.where(elig_f, f_scores_f, -math.inf).reshape(-1)
    best_sum = flat.max()
    order = (
        (sel_theta[:, None] * nxf + offs_x[None, :]) * nyf + offs_y[None, :]
    ).reshape(-1)
    best = torch.where(flat == best_sum, order, np.iinfo(np.int64).max).argmin()
    rt, oi = best // n_off, best % n_off
    bt = _at(sel_theta, rt)
    bx = _at(offs_x, oi)
    by = _at(offs_y, oi)
    best_score = best_sum * norm
    best_known = _at(f_known_f.reshape(-1), best) * norm
    pose_found = best_score > score_threshold
    exact = torch.ones((), dtype=torch.bool, device=dev)
    if use_topk:
        exact = exact & (best_sum >= kth_bound)
    if use_blocks:
        exact = exact & (best_sum >= blk_next_bound)
    if use_int8:
        exact = exact & int8_ok

    best_sensor_pose = torch.stack([
        sensor_pose[0] + (bx.to(torch.float32) - wx) * cfg.resolution,
        sensor_pose[1] + (by.to(torch.float32) - wy) * cfg.resolution,
        sensor_pose[2] + (theta0 + bt).to(torch.float32) * step_theta,
    ])

    ccfg = cfg.cost or CostConfig(covariance_scale=cfg.covariance_scale)
    cost_val = cost_at(
        ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
        cfg.resolution, offset_xy,
    )
    cov = covariance_at(
        ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
        cfg.resolution, offset_xy,
    )
    # Candidate accounting over the full theta window (parity with the
    # reference's NumOfProcessedNodes / NumOfIgnoredNodes series).
    n_processed = block_ok.sum() * (LR ** 2)
    n_total = theta_mask.sum() * (nxf * nyf)
    return (best_sensor_pose, best_score, best_known, pose_found,
            cost_val * norm, cov, n_processed, n_total, exact)


class MatcherMetrics:
    """The reference's per-matcher series set
    (``scan_matcher_correlative.cpp:16-71``)."""

    _NAMES = (
        "InputSetupTime", "OptimizationTime", "DiffTranslation",
        "DiffRotation", "WinSizeX", "WinSizeY", "WinSizeTheta",
        "StepSizeX", "StepSizeY", "StepSizeTheta", "NumOfIgnoredNodes",
        "NumOfProcessedNodes", "ScoreValue", "CostValue", "NumOfScans",
    )

    def __init__(self, matcher_name: str):
        vs = MetricManager.instance().value_sequence
        for n in self._NAMES:
            setattr(self, n, vs(f"{matcher_name}.{n}"))


class ScanMatcherCorrelative:
    """Host-side wrapper holding the static config, the device and the
    coarse-map cache."""

    def __init__(self, cfg: CorrelativeConfig, device,
                 name: str = "ScanMatcherCorrelative"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.name = name
        self.metrics = MatcherMetrics(name)
        self.host_fetches = 0

    def coarse_of(self, grid_map: MapRaster):
        key = ("swmax", self.cfg.low_resolution)
        if key not in grid_map.coarse:
            grid_map.coarse[key] = (
                pool.sliding_window_max2d(grid_map.prob, self.cfg.low_resolution),
                pool.sliding_window_max2d(grid_map.observed,
                                          self.cfg.low_resolution),
            )
        return grid_map.coarse[key]

    def optimize_pose(self, query: ScanMatchingQuery,
                      score_threshold: float = 0.0,
                      known_rate_threshold: float = 0.0) -> ScanMatchingSummary:
        t0 = time.perf_counter()
        gm, scan = query.grid_map, query.scan
        sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
        coarse_prob, coarse_obs = self.coarse_of(gm)
        mm = self.metrics
        mm.InputSetupTime.observe(int((time.perf_counter() - t0) * 1e6))
        t1 = time.perf_counter()
        args = (
            self.cfg, gm.prob, gm.observed, coarse_prob, coarse_obs,
            scan.ranges, scan.angles, scan.mask,
            to_device(sensor_pose, self.device, np.float32),
            to_device(gm.offset_xy, self.device, np.float32),
            float(np.float32(score_threshold)),
            float(np.float32(known_rate_threshold)),
        )
        # One device-to-host fetch for the whole result tuple.
        out = fetch(correlative_core(*args))
        self.host_fetches += 1
        if not out[-1]:
            # A prune could not certify the argmax: redo densely.
            MetricManager.instance().counter(
                f"{self.name}.DenseFallbacks"
            ).increment()
            out = fetch(correlative_core(*args, dense=True))
            self.host_fetches += 1
        pose_s, score, known, found, ncost, cov, n_proc, n_total, _ = out
        est_pose = P.move_backward(pose_s, scan.rel_sensor_pose)
        mm.OptimizationTime.observe(int((time.perf_counter() - t1) * 1e6))
        self._observe_metrics(
            query, scan, est_pose, score, ncost, int(n_proc), int(n_total)
        )
        return ScanMatchingSummary(
            pose_found=bool(found),
            normalized_cost=float(ncost),
            initial_pose=np.asarray(query.initial_pose),
            estimated_pose=est_pose,
            covariance=cov,
            normalized_score=float(score),
            known_rate=float(known),
        )

    def _observe_metrics(self, query, scan, est_pose, score, ncost, n_proc,
                         n_total):
        """Observe the reference series (``scan_matcher_correlative.cpp:
        304-345``) from host-side values only."""
        cfg = self.cfg
        mm = self.metrics
        diff = P.inverse_compound(query.initial_pose, est_pose)
        mm.DiffTranslation.observe(float(P.distance(diff)))
        mm.DiffRotation.observe(abs(float(diff[2])))
        wx, wy = cfg.win_cells
        nbx, nby = cfg.blocks
        n_theta = n_total // (nbx * nby * cfg.low_resolution ** 2)
        max_range = float(scan.max_range)
        step_theta = 2.0 * math.asin(
            min(1.0, 0.5 * cfg.resolution / max(max_range, 1e-6))
        )
        mm.WinSizeX.observe(2 * wx)
        mm.WinSizeY.observe(2 * wy)
        mm.WinSizeTheta.observe(n_theta)
        mm.StepSizeX.observe(cfg.resolution)
        mm.StepSizeY.observe(cfg.resolution)
        mm.StepSizeTheta.observe(step_theta)
        mm.NumOfIgnoredNodes.observe(n_total - n_proc)
        mm.NumOfProcessedNodes.observe(n_proc)
        mm.ScoreValue.observe(float(score))
        mm.CostValue.observe(float(ncost))
        mm.NumOfScans.observe(int(scan.num_valid))
