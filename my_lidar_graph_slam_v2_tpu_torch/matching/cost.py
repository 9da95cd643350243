"""Config-selectable cost functions for the matchers.

Port of ``my_lidar_graph_slam_v2_tpu/matching/cost.py``
(``cost_function_factory.cpp:51-66``).  The SquareError cost is ported;
GreedyEndpoint is ROADMAP item 1.15 and raises.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..ops import gauss_newton

COST_SQUARE_ERROR = "SquareError"
COST_GREEDY_ENDPOINT = "GreedyEndpoint"


@dataclass(frozen=True)
class CostConfig:
    """CostType + the union of both cost groups' parameters (field for
    field the JAX package's ``CostConfig``)."""

    cost_type: str = COST_SQUARE_ERROR
    covariance_scale: float = 1e4
    hit_and_missed_dist: float = 0.075
    occupancy_threshold: float = 0.1
    kernel_size: int = 1
    standard_deviation: float = 0.05
    scaling_factor: float = 1.0

    def __post_init__(self):
        if self.cost_type not in (COST_SQUARE_ERROR, COST_GREEDY_ENDPOINT):
            raise ValueError(f"unknown cost type: {self.cost_type}")


def _require_square_error(ccfg: CostConfig):
    if ccfg.cost_type != COST_SQUARE_ERROR:
        raise NotImplementedError(
            f"cost type {ccfg.cost_type!r} is not ported yet "
            "(ROADMAP item 1.15: ops/greedy_endpoint.py)"
        )


def cost_at(ccfg: CostConfig, prob, observed, ranges, angles, mask,
            sensor_pose, resolution, offset_xy, map_index=None):
    """Total cost at a map-local sensor pose (per candidate for batched
    beams, see ``ops/gauss_newton.py``)."""
    _require_square_error(ccfg)
    return gauss_newton.cost(
        prob, observed, ranges, angles, mask, sensor_pose, resolution,
        offset_xy, map_index,
    )


def covariance_at(ccfg: CostConfig, prob, observed, ranges, angles, mask,
                  sensor_pose, resolution, offset_xy, map_index=None):
    """Pose covariance at a map-local sensor pose: scale * H^{-1}
    (``cost_function_square_error.cpp:131-146``)."""
    _require_square_error(ccfg)
    return gauss_newton.covariance(
        prob, observed, ranges, angles, mask, sensor_pose, resolution,
        offset_xy, ccfg.covariance_scale, map_index,
    )
