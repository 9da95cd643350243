"""Hill-climbing scan matcher.

Port of ``my_lidar_graph_slam_v2_tpu/matching/hill_climbing.py``
(``mapping/scan_matcher_hill_climbing.cpp:63-169``): greedy descent over
the 6 neighbours (+-x, +-y, +-theta) of the best pose, halving both steps
after each iteration that finds no better neighbour.  The accept and halve
loop runs on the host in f64 NumPy, as in the JAX package; each iteration
scores its 6 moves in one batched ``cost_at`` call and fetches the costs
once.

The default cost is GreedyEndpoint, the reference's pairing.  Its per-beam
sums are exact (``ops/greedy_endpoint.py``), so two moves often tie
exactly; the JAX package's f32 sum may break such a tie by an ulp either
way, and the climb then takes another move (``tests/
test_torch_matchers_more.py`` bounds how often).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import pose as P
from ..utils.transfer import fetch, to_device
from .cost import CostConfig, cost_at, covariance_at
from .types import ScanMatchingQuery, ScanMatchingSummary

_MOVES = np.array(
    [
        [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
    ]
)


@dataclass(frozen=True)
class HillClimbingConfig:
    """Field for field the JAX package's ``HillClimbingConfig``."""

    linear_step: float = 0.1
    angular_step: float = 0.1
    max_iterations: int = 100
    max_num_of_refinements: int = 5
    resolution: float = 0.05
    cost: CostConfig = CostConfig(cost_type="GreedyEndpoint")


class ScanMatcherHillClimbing:
    """Host wrapper holding the static config, the device and counters:
    ``matches`` and ``iterations`` (a fetch each, plus the start cost's
    and the covariance's)."""

    def __init__(self, cfg: HillClimbingConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.matches = 0
        self.iterations = 0

    def optimize_pose(self, query: ScanMatchingQuery, **_) -> ScanMatchingSummary:
        cfg = self.cfg
        gm, scan = query.grid_map, query.scan
        sensor_pose = np.asarray(
            P.compound(query.initial_pose, scan.rel_sensor_pose), np.float64
        )
        off = to_device(gm.offset_xy, self.device, np.float32)
        args = (gm.prob, gm.observed, scan.ranges, scan.angles, scan.mask)

        def costs(poses):
            c = cost_at(cfg.cost, *args, to_device(poses, self.device,
                                                   np.float32),
                        cfg.resolution, off)
            return fetch((c,))[0].astype(np.float32)

        min_cost = float(costs(sensor_pose[None])[0])
        best = sensor_pose.copy()
        lin, ang = cfg.linear_step, cfg.angular_step
        iters = refinements = 0
        while True:
            cand = best[None, :] + _MOVES * np.array([lin, lin, ang])[None, :]
            c = costs(cand)
            i = int(np.argmin(c))
            if c[i] < min_cost:
                min_cost = float(c[i])
                best = cand[i]
                updated = True
            else:
                refinements += 1
                lin *= 0.5
                ang *= 0.5
                updated = False
            iters += 1
            if not (
                (updated or refinements < cfg.max_num_of_refinements)
                and iters < cfg.max_iterations
            ):
                break

        n = max(scan.num_valid, 1)
        cov = covariance_at(cfg.cost, *args,
                            to_device(best, self.device, np.float32),
                            cfg.resolution, off)
        (cov,) = fetch((cov,))
        self.matches += 1
        self.iterations += iters
        return ScanMatchingSummary(
            pose_found=True,
            normalized_cost=min_cost / n,
            initial_pose=np.asarray(query.initial_pose),
            estimated_pose=P.move_backward(best, scan.rel_sensor_pose),
            covariance=cov,
        )
