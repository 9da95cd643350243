"""Real-time correlative scan matcher.

Port of ``my_lidar_graph_slam_v2_tpu/matching/correlative.py``
(``scan_matcher_correlative.cpp:116-368``): the whole pose window is
scored by a strided coarse sweep and a stride-1 fine sweep
(``ops/csm.py:sweep``, the CUDA kernel on the card), gated by the coarse
blocks, and the winner picked by a masked argmax with the reference's
(theta, x, y) tie-break.

Both sweep backends of the JAX package: ``"matmul"`` (the default:
beam cells in a crop, a pooled coarse window, the top-K theta and top-B
block prunes) and ``"gather"`` (the semantics oracle: map cells with no
crop, the coarse sweep on the full sliding-window-max map, the top-K
thetas over the whole fine window).  Both run through ``ops/csm.py:sweep``
(on the card one launch per sweep of the window type's kernel): u8 maps
as u8 windows, f32 maps and ``precision="highest"`` as f32 windows rounded
at the configured precision (the gather backend's are not rounded, as the
JAX gathers contract in f32 at any precision).  The prunes are certified
exactly as in the JAX package, and the int8 multiplicity certificate is
kept where the JAX package takes its int8 sweep (u8 maps, not
``"highest"``, matmul backend) so ``exact`` (and with it the dense
re-runs) matches the reference.  Top-K uses a stable descending sort:
``jax.lax.top_k`` puts the lower index first on ties, and coarse bounds,
multiples of 1/255, tie often.
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
    """(values, indices) of the k largest along the last axis, lower index
    first on ties — the order of ``jax.lax.top_k``."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def coarse_of(raster: MapRaster, low_resolution: int):
    """The raster's full sliding-window-max coarse maps, cached on its map
    cache entry; the serial matchers and the batched loop detector share
    the slot."""
    key = ("swmax", low_resolution)
    if key not in raster.coarse:
        raster.coarse[key] = (
            pool.sliding_window_max2d(raster.prob, low_resolution),
            pool.sliding_window_max2d(raster.observed, low_resolution),
        )
    return raster.coarse[key]


def _pick(values, index):
    """``values[n, index[n]]`` for each row n, on the device (indexing
    with a device tensor would go through the host)."""
    return torch.take_along_dim(values, index[:, None], dim=1)[:, 0]


def correlative_core_batch(cfg: CorrelativeConfig, prob, observed,
                           coarse_prob, coarse_observed, ranges, angles, mask,
                           sensor_pose, offset_xy, score_threshold,
                           known_rate_threshold, *, map_index=None,
                           dense: bool = False, sweep_fn=None):
    """``_correlative_core`` for N candidates at once (the body of the JAX
    package's ``vmap``, ``parallel/loop_sharded.py:49-63``): beams ``[N,
    B]``, map-local sensor poses ``[N, 3]`` and raster offsets ``[N, 2]``;
    the maps are one raster ``[H, W]`` for all, or the stack of a step's
    distinct rasters ``[M, H, W]`` with ``map_index`` (i64 ``[N]``).
    ``coarse_prob`` / ``coarse_observed`` are the full sliding-window-max
    maps of the same rasters, or None to pool over each crop.

    One coarse and one fine sweep launch serve the whole batch.  Every
    step is per candidate (its own theta step and window, crop anchor,
    top-K thetas, top-B blocks and tie-break), and nothing sums across the
    candidate axis, so each row equals the single-candidate call.  Returns
    the 9-tuple (pose, score, known, found, cost / n, cov, n_processed,
    n_total, exact) with a leading ``N`` axis, on the device.

    ``sweep_fn``, if given, is called in place of ``ops/csm.py:sweep``
    for both sweeps (``models/fused_matcher.py`` captures the work
    around them)."""
    run_sweep = sweep_fn or csm.sweep
    if cfg.sweep_backend not in ("matmul", "gather"):
        raise ValueError(f"unknown sweep_backend {cfg.sweep_backend!r}")
    gather = cfg.sweep_backend == "gather"
    exact_u8 = csm.u8_exact(prob, cfg.precision)
    dev = prob.device
    N = ranges.shape[0]
    wx, wy = cfg.win_cells
    nbx, nby = cfg.blocks
    LR = cfg.low_resolution
    nxf, nyf = nbx * LR, nby * LR
    T = cfg.n_theta_max
    CR, CC = cfg.crop_rows, cfg.crop_cols

    step_theta, theta0, theta_mask = csm.theta_search_params(
        ranges, mask, cfg.resolution, cfg.range_theta, T
    )
    n_valid = mask.sum(dim=-1).to(torch.float32)
    norm = 1.0 / torch.clamp(n_valid, min=1.0)  # [N]
    norm4 = norm[:, None, None, None]
    x0, y0 = -wx, -wy

    if gather:
        # Map cells shared by both sweeps, no crop; the coarse sweep reads
        # the full sliding-window-max maps.
        if coarse_prob is None:
            coarse_prob = pool.sliding_window_max2d(prob, LR)
            coarse_observed = pool.sliding_window_max2d(observed, LR)
        hr, hc, ok_tb = csm.beam_cells_abs(
            ranges, angles, mask, sensor_pose, theta0, step_theta,
            theta_mask, cfg.resolution, offset_xy, n_theta=T,
        )  # [N, T, B]
        c_scores, c_known = csm.sweep_windows(
            coarse_prob, coarse_observed, hr, hc, ok_tb, y0, x0,
            ny=nby, nx=nbx, stride=LR, map_index=map_index, sweep_fn=sweep_fn,
        )  # [N, T, nby, nbx]
    else:
        hr, hc, valid, r0, c0 = csm.beam_cells(
            ranges, angles, mask, sensor_pose, theta0, step_theta,
            theta_mask, cfg.resolution, offset_xy, n_theta=T, crop_rows=CR,
            crop_cols=CC,
        )  # [N, T, B], [N]
        ok_tb = valid & theta_mask[:, :, None]
        use_int8 = (not dense) and cfg.coarse_int8 and exact_u8
        if use_int8:
            int8_ok = csm.max_hit_multiplicity(hr, hc, ok_tb,
                                               crop_cols=CC) <= 127

        # Coarse window: pooled over the crop only (pool-on-crop) unless
        # the caller holds full pooled maps.  Both give the same values:
        # an f32 window is pooled unrounded and rounded after, as the JAX
        # package rounds the pooled window.
        in_rows, in_cols = CR + (nby - 1) * LR, CC + (nbx - 1) * LR
        if coarse_prob is None:
            seg = csm.sweep_input_window(
                prob, observed, r0, c0, x0, y0, map_index=map_index,
                in_rows=in_rows + LR - 1, in_cols=in_cols + LR - 1,
                precision=cfg.precision if exact_u8 else "highest",
            )
            pooled = pool.sliding_window_max2d(seg.permute(0, 3, 1, 2), LR)
            coarse_inp = csm.round_window(
                pooled.permute(0, 2, 3, 1)[:, :in_rows, :in_cols],
                cfg.precision)
        else:
            coarse_inp = csm.sweep_input_window(
                coarse_prob, coarse_observed, r0, c0, x0, y0,
                map_index=map_index, in_rows=in_rows, in_cols=in_cols,
                precision=cfg.precision,
            )
        origin = torch.zeros((N, 1, 2), dtype=torch.int32, device=dev)
        c = run_sweep(
            coarse_inp.contiguous(), hr, hc, ok_tb, origin,
            tile_h=nby, tile_w=nbx, stride=LR,
        )  # [N, T, 2, nby * nbx]
        c_scores = c[:, :, 0].reshape(N, T, nby, nbx)
        c_known = c[:, :, 1].reshape(N, T, nby, nbx)

    # Reference gating (scan_matcher_correlative.cpp:178-189)
    block_ok = (
        (c_scores * norm4 > score_threshold)
        & (c_known * norm4 > known_rate_threshold)
        & theta_mask[:, :, None, None]
    )

    use_topk = (not dense) and 0 < cfg.fine_theta_k < T
    if use_topk:
        K = cfg.fine_theta_k
        bound = torch.where(block_ok, c_scores, -math.inf).amax(dim=(2, 3))
        kth, sel_theta = _top(bound, K)  # [N, K]
        kth_bound = kth[:, K - 1]
        sel4 = sel_theta[:, :, None, None]
        ok_rows = torch.take_along_dim(block_ok, sel4, dim=1)
    else:
        sel_theta = torch.arange(T, device=dev).expand(N, T)
        ok_rows = block_ok
    R = ok_rows.shape[1]

    n_blocks = nby * nbx
    use_blocks = (not dense and not gather
                  and 0 < cfg.fine_block_b < n_blocks)
    if use_blocks:
        # Top-B coarse-block prune: sweep only the offsets of the B blocks
        # with the largest gated coarse bound, one LR x LR tile each.
        Bb = cfg.fine_block_b
        c_sel = (torch.take_along_dim(c_scores, sel4, dim=1) if use_topk
                 else c_scores)
        blk_bound = torch.where(ok_rows, c_sel, -math.inf).amax(dim=1)
        bvals, bidx = _top(blk_bound.reshape(N, -1), Bb + 1)
        blk_next_bound = bvals[:, Bb]
        bsel = bidx[:, :Bb]  # [N, Bb]
        origins = torch.stack([bsel // nbx * LR, bsel % nbx * LR], dim=-1)
        tile_h = tile_w = LR
        elig_f = torch.take_along_dim(
            ok_rows.reshape(N, R, -1), bsel[:, None, :], dim=2)
        elig_f = elig_f.repeat_interleave(LR * LR, dim=2)
    else:
        origins = torch.zeros((N, 1, 2), dtype=torch.int64, device=dev)
        tile_h, tile_w = nyf, nxf
        elig_f = ok_rows.repeat_interleave(LR, dim=2).repeat_interleave(
            LR, dim=3
        ).reshape(N, R, -1)
    # The sweep's offsets in its output order (tile-major, then j, then i).
    off = csm.tile_offsets(origins, tile_h=tile_h, tile_w=tile_w, stride=1)
    offs_y, offs_x = off[..., 0], off[..., 1]  # [N, n_off]

    if use_topk:
        sel3 = sel_theta[:, :, None]
        hr_s, hc_s, ok_s = (torch.take_along_dim(a, sel3, dim=1)
                            for a in (hr, hc, ok_tb))
    else:
        hr_s, hc_s, ok_s = hr, hc, ok_tb
    if gather:
        f = torch.stack(csm.sweep_windows(
            prob, observed, hr_s, hc_s, ok_s, y0, x0, ny=nyf, nx=nxf,
            stride=1, map_index=map_index, sweep_fn=sweep_fn,
        ), dim=2).reshape(N, R, 2, -1)
    else:
        fine_inp = csm.sweep_input_window(
            prob, observed, r0, c0, x0, y0, map_index=map_index,
            in_rows=CR + nyf - 1, in_cols=CC + nxf - 1,
            precision=cfg.precision,
        )
        f = run_sweep(
            fine_inp, hr_s, hc_s, ok_s, origins.to(torch.int32),
            tile_h=tile_h, tile_w=tile_w, stride=1,
        )  # [N, R, 2, n_off]
    f_scores_f, f_known_f = f[:, :, 0], f[:, :, 1]
    n_off = f_scores_f.shape[2]

    # Winner with the reference's (theta, x, y) loop-nesting tie-break.
    flat = torch.where(elig_f, f_scores_f, -math.inf).reshape(N, -1)
    best_sum = flat.amax(dim=1)
    order = (
        (sel_theta[:, :, None] * nxf + offs_x[:, None, :]) * nyf
        + offs_y[:, None, :]
    ).reshape(N, -1)
    best = torch.where(flat == best_sum[:, None], order,
                       np.iinfo(np.int64).max).argmin(dim=1)
    rt, oi = best // n_off, best % n_off
    bt = _pick(sel_theta, rt)
    bx = _pick(offs_x, oi)
    by = _pick(offs_y, oi)
    best_score = best_sum * norm
    best_known = _pick(f_known_f.reshape(N, -1), best) * norm
    pose_found = best_score > score_threshold
    exact = torch.ones((N,), dtype=torch.bool, device=dev)
    if use_topk:
        exact = exact & (best_sum >= kth_bound)
    if use_blocks:
        exact = exact & (best_sum >= blk_next_bound)
    if (not gather) and use_int8:
        exact = exact & int8_ok

    best_sensor_pose = torch.stack([
        sensor_pose[:, 0] + (bx.to(torch.float32) - wx) * cfg.resolution,
        sensor_pose[:, 1] + (by.to(torch.float32) - wy) * cfg.resolution,
        sensor_pose[:, 2] + (theta0 + bt).to(torch.float32) * step_theta,
    ], dim=-1)

    ccfg = cfg.cost or CostConfig(covariance_scale=cfg.covariance_scale)
    cost_val = cost_at(
        ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
        cfg.resolution, offset_xy, map_index,
    )
    cov = covariance_at(
        ccfg, prob, observed, ranges, angles, mask, best_sensor_pose,
        cfg.resolution, offset_xy, map_index,
    )
    # Candidate accounting over the full theta window (parity with the
    # reference's NumOfProcessedNodes / NumOfIgnoredNodes series).
    n_processed = block_ok.sum(dim=(1, 2, 3)) * (LR ** 2)
    n_total = theta_mask.sum(dim=1) * (nxf * nyf)
    return (best_sensor_pose, best_score, best_known, pose_found,
            cost_val * norm, cov, n_processed, n_total, exact)


def correlative_core(cfg: CorrelativeConfig, prob, observed, coarse_prob,
                     coarse_observed, ranges, angles, mask, sensor_pose,
                     offset_xy, score_threshold, known_rate_threshold, *,
                     dense: bool = False, sweep_fn=None):
    """Port of ``_correlative_core`` for one candidate: the batched core
    at N = 1 on one raster ``[H, W]``.  Returns the same 9-tuple of device
    tensors (pose, score, known, found, cost / n, cov, n_processed,
    n_total, exact)."""
    out = correlative_core_batch(
        cfg, prob, observed, coarse_prob, coarse_observed, ranges[None],
        angles[None], mask[None], sensor_pose[None], offset_xy[None],
        score_threshold, known_rate_threshold, dense=dense,
        sweep_fn=sweep_fn,
    )
    return tuple(o[0] for o in out)


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
        self._spans = (f"{name}.InputSetupTime", f"{name}.OptimizationTime")

    def coarse_of(self, grid_map: MapRaster):
        return coarse_of(grid_map, self.cfg.low_resolution)

    def optimize_pose(self, query: ScanMatchingQuery,
                      score_threshold: float = 0.0,
                      known_rate_threshold: float = 0.0) -> ScanMatchingSummary:
        span = MetricManager.instance().span
        mm = self.metrics
        with span(self._spans[0], mm.InputSetupTime):
            gm, scan = query.grid_map, query.scan
            sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
            coarse_prob, coarse_obs = self.coarse_of(gm)
        with span(self._spans[1], mm.OptimizationTime):
            args = (
                self.cfg, gm.prob, gm.observed, coarse_prob, coarse_obs,
                scan.ranges, scan.angles, scan.mask,
                to_device(sensor_pose, self.device, np.float32),
                to_device(gm.offset_xy, self.device, np.float32),
                float(np.float32(score_threshold)),
                float(np.float32(known_rate_threshold)),
            )
            with span("match.search"):
                out = correlative_core(*args)
            # One device-to-host fetch for the whole result tuple.
            out = fetch(out)
            if not out[-1]:
                # A prune could not certify the argmax: redo densely.
                MetricManager.instance().counter(
                    f"{self.name}.DenseFallbacks"
                ).increment()
                with span("match.search"):
                    out = correlative_core(*args, dense=True)
                out = fetch(out)
            pose_s, score, known, found, ncost, cov, n_proc, n_total, _ = out
            est_pose = P.move_backward(pose_s, scan.rel_sensor_pose)
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
