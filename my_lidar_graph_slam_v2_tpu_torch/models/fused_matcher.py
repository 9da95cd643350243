"""Fused frontend matcher: latest-map fold, CSM window search and GN
refinement as one device sequence with one result fetch.

Port of ``my_lidar_graph_slam_v2_tpu/models/fused_matcher.py``
(``lidar_graph_slam_frontend.cpp:210-237``).  The JAX package compiles
the whole two-stage match into one jit; here it is one eager sequence of
device ops (on the card the two CSM sweeps are the sweep kernel and the
refinement with its covariance one launch of the Gauss-Newton kernel) whose
results come back to the host in a single transfer per keyframe — two
when a prune cannot certify the argmax and the dense sweep re-runs.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import pose as P
from ..matching.correlative import (
    CorrelativeConfig,
    ScanMatcherCorrelative,
    correlative_core,
)
from ..matching.linear_solver import LinearSolverConfig, LinearSolverMetrics
from ..matching.types import (
    ScanMatchingQuery,
    ScanMatchingSummary,
)
from ..metrics.registry import MetricManager
from ..ops import gauss_newton, quant, rasterize
from ..utils.transfer import fetch, to_device


def fused_body(ccfg: CorrelativeConfig, lcfg: LinearSolverConfig, prob,
               observed, coarse_p, coarse_o, ranges, angles, mask,
               sensor_pose, offset_xy, score_threshold, known_rate_threshold,
               *, dense: bool = False):
    """CSM search then GN refinement and covariance; returns the JAX
    ``_fused_body``'s 12-tuple as device tensors."""
    span = MetricManager.instance().span
    with span("match.search"):
        (csm_pose, score, known, found, csm_ncost, _, n_proc, n_total,
         exact) = correlative_core(
            ccfg, prob, observed, coarse_p, coarse_o, ranges, angles, mask,
            sensor_pose, offset_xy, score_threshold, known_rate_threshold,
            dense=dense,
        )
    with span("match.refine"):
        n = torch.clamp(mask.sum().to(torch.float32), min=1.0)
        refined, cost, iters, cov, _ = gauss_newton.refine(
            prob, observed, ranges, angles, mask, csm_pose, ccfg.resolution,
            offset_xy,
            max_iterations=lcfg.num_iterations_max,
            convergence_threshold=lcfg.convergence_threshold,
            initial_lambda=lcfg.initial_lambda,
            covariance_scale=lcfg.covariance_scale,
        )
    return (refined, cov, score, known, found, torch.div(cost, n), iters,
            n_proc, n_total, csm_pose, csm_ncost, exact)


def fused_core_deltas(ccfg: CorrelativeConfig, lcfg: LinearSolverConfig,
                      deltas, shifts, valid, ranges, angles, mask,
                      sensor_pose, offset_xy, score_threshold,
                      known_rate_threshold, *, max_shift: int,
                      dense: bool = False):
    """The whole frontend keyframe match (``_fused_core_deltas``):
    latest-map fold from per-scan deltas -> u8 quantize -> pool-on-crop
    -> coarse + fine CSM sweeps -> GN refinement -> covariance."""
    with MetricManager.instance().span("match.fold"):
        lo, obs = rasterize.fold_shifted_deltas(
            deltas, shifts, valid, max_shift=max_shift
        )
        prob = quant.quantize_prob(lo, obs)
    return fused_body(
        ccfg, lcfg, prob, obs, None, None, ranges, angles, mask,
        sensor_pose, offset_xy, score_threshold, known_rate_threshold,
        dense=dense,
    )


class FusedCorrelativeGNMatcher:
    """Drop-in two-stage matcher; ``fused = True`` tells the frontend to
    skip its separate final-matcher call."""

    fused = True
    supports_deltas = True

    def __init__(self, ccfg: CorrelativeConfig, lcfg: LinearSolverConfig,
                 device, name: str = "ScanMatcherCorrelativeFused",
                 final_name: str = None, final_time_fraction: float = 0.5):
        self.ccfg = ccfg
        self.lcfg = lcfg
        self.device = torch.device(device)
        self.name = name
        self._series = ScanMatcherCorrelative(ccfg, device, name)
        self.metrics = self._series.metrics
        self.final_time_fraction = final_time_fraction
        self.final_metrics = (
            LinearSolverMetrics(final_name) if final_name else None
        )
        self._setup_span = f"{name}.InputSetupTime"

    def coarse_of(self, grid_map):
        return self._series.coarse_of(grid_map)

    def _run(self, core, args, kw):
        out = fetch(core(*args, **kw))
        if not out[-1]:
            MetricManager.instance().counter(
                f"{self.name}.DenseFallbacks"
            ).increment()
            out = fetch(core(*args, dense=True, **kw))
        return out

    def optimize_pose_deltas(self, fold, scan, initial_pose,
                             score_threshold: float = 0.0,
                             known_rate_threshold: float = 0.0
                             ) -> ScanMatchingSummary:
        t1 = time.perf_counter()
        sensor_pose = P.compound(initial_pose, scan.rel_sensor_pose)
        args = (
            self.ccfg, self.lcfg, fold["deltas"], fold["shifts"],
            fold["valid"], scan.ranges, scan.angles, scan.mask,
            to_device(sensor_pose, self.device, np.float32),
            to_device(fold["offset_xy"], self.device, np.float32),
            float(np.float32(score_threshold)),
            float(np.float32(known_rate_threshold)),
        )
        out = self._run(fused_core_deltas, args,
                        dict(max_shift=fold["max_shift"]))
        self.metrics.InputSetupTime.observe(0)
        return self._finish(out, initial_pose, scan, t1)

    def optimize_pose(self, query: ScanMatchingQuery,
                      score_threshold: float = 0.0,
                      known_rate_threshold: float = 0.0
                      ) -> ScanMatchingSummary:
        with MetricManager.instance().span(self._setup_span,
                                           self.metrics.InputSetupTime):
            gm, scan = query.grid_map, query.scan
            sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
            coarse_p, coarse_o = self.coarse_of(gm)
        t1 = time.perf_counter()
        args = (
            self.ccfg, self.lcfg, gm.prob, gm.observed, coarse_p, coarse_o,
            scan.ranges, scan.angles, scan.mask,
            to_device(sensor_pose, self.device, np.float32),
            to_device(gm.offset_xy, self.device, np.float32),
            float(np.float32(score_threshold)),
            float(np.float32(known_rate_threshold)),
        )
        out = self._run(fused_body, args, {})
        return self._finish(out, query.initial_pose, scan, t1)

    def _finish(self, out, initial_pose, scan, t1) -> ScanMatchingSummary:
        (refined, cov, score, known, found, ncost, iters, n_proc, n_total,
         csm_pose, csm_ncost, _) = out
        est = P.move_backward(refined, scan.rel_sensor_pose)
        wall_us = int((time.perf_counter() - t1) * 1e6)
        frac = self.final_time_fraction if self.final_metrics else 0.0
        self.metrics.OptimizationTime.observe(int(wall_us * (1.0 - frac)))
        csm_est = P.move_backward(csm_pose, scan.rel_sensor_pose)

        class _Q:  # _observe_metrics reads only .initial_pose
            pass

        q = _Q()
        q.initial_pose = np.asarray(initial_pose)
        self._series._observe_metrics(
            q, scan, csm_est, score, csm_ncost, int(n_proc), int(n_total)
        )
        if self.final_metrics is not None:
            fm = self.final_metrics
            fm.OptimizationTime.observe(int(wall_us * frac))
            diff = P.inverse_compound(csm_est, est)
            fm.DiffTranslation.observe(float(P.distance(diff)))
            fm.DiffRotation.observe(abs(float(diff[2])))
            fm.NumOfIterations.observe(int(iters))
            fm.InitialCost.observe(float(csm_ncost))
            fm.FinalCost.observe(float(ncost))
            fm.NumOfScans.observe(int(scan.num_valid))
        return ScanMatchingSummary(
            pose_found=bool(found),
            normalized_cost=float(ncost),
            initial_pose=np.asarray(initial_pose),
            estimated_pose=est,
            covariance=cov,
            normalized_score=float(score),
            known_rate=float(known),
        )
