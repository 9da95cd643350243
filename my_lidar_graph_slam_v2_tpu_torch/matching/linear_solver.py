"""Gauss-Newton (damped) sub-pixel scan matcher.

Port of ``my_lidar_graph_slam_v2_tpu/matching/linear_solver.py``
(``scan_matcher_linear_solver.cpp``).  The refinement runs on the
matcher's device (``ops/gauss_newton.py:refine``: one kernel launch on
the card); the result comes back in one host fetch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import pose as P
from ..metrics.registry import MetricManager
from ..ops import gauss_newton
from ..utils.transfer import fetch, to_device
from .types import (
    ScanMatchingQuery,
    ScanMatchingSummary,
)


@dataclass(frozen=True)
class LinearSolverConfig:
    num_iterations_max: int = 10
    convergence_threshold: float = 1e-4
    initial_lambda: float = 1e-4
    resolution: float = 0.05
    covariance_scale: float = 1e4


def refine_core(cfg, prob, observed, ranges, angles, mask, sensor_pose,
                offset_xy):
    """(pose, cost / n, cov, iters, initial cost / n) as device tensors."""
    with MetricManager.instance().span("match.refine"):
        n = torch.clamp(mask.sum().to(torch.float32), min=1.0)
        pose, cost, iters, cov, cost0 = gauss_newton.refine(
            prob, observed, ranges, angles, mask, sensor_pose,
            cfg.resolution, offset_xy,
            max_iterations=cfg.num_iterations_max,
            convergence_threshold=cfg.convergence_threshold,
            initial_lambda=cfg.initial_lambda,
            covariance_scale=cfg.covariance_scale,
        )
    return pose, torch.div(cost, n), cov, iters, torch.div(cost0, n)


class LinearSolverMetrics:
    """Reference series set (``scan_matcher_linear_solver.cpp:15-53``)."""

    _NAMES = (
        "OptimizationTime", "DiffTranslation", "DiffRotation",
        "NumOfIterations", "InitialCost", "FinalCost", "NumOfScans",
    )

    def __init__(self, matcher_name: str):
        vs = MetricManager.instance().value_sequence
        for n in self._NAMES:
            setattr(self, n, vs(f"{matcher_name}.{n}"))


class ScanMatcherLinearSolver:
    def __init__(self, cfg: LinearSolverConfig, device,
                 name: str = "FinalScanMatcherLinearSolver"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.name = name
        self.metrics = LinearSolverMetrics(name)
        self._span = f"{name}.OptimizationTime"

    def optimize_pose(self, query: ScanMatchingQuery, **_) -> ScanMatchingSummary:
        mm = self.metrics
        with MetricManager.instance().span(self._span, mm.OptimizationTime):
            gm, scan = query.grid_map, query.scan
            sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
            pose, ncost, cov, iters, ncost0 = fetch(refine_core(
                self.cfg, gm.prob, gm.observed, scan.ranges, scan.angles,
                scan.mask,
                to_device(sensor_pose, self.device, np.float32),
                to_device(gm.offset_xy, self.device, np.float32),
            ))
            est_pose = P.move_backward(pose, scan.rel_sensor_pose)
        diff = P.inverse_compound(query.initial_pose, est_pose)
        mm.DiffTranslation.observe(float(P.distance(diff)))
        mm.DiffRotation.observe(abs(float(diff[2])))
        mm.NumOfIterations.observe(int(iters))
        mm.InitialCost.observe(float(ncost0))
        mm.FinalCost.observe(float(ncost))
        mm.NumOfScans.observe(int(scan.num_valid))
        return ScanMatchingSummary(
            pose_found=True,
            normalized_cost=float(ncost),
            initial_pose=np.asarray(query.initial_pose),
            estimated_pose=est_pose,
            covariance=cov,
        )
