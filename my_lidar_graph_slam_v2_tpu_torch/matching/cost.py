"""Config-selectable cost functions for the matchers.

Port of ``my_lidar_graph_slam_v2_tpu/matching/cost.py``
(``cost_function_factory.cpp:51-66``): CostType SquareError
(``ops/gauss_newton.py``) or GreedyEndpoint (``ops/greedy_endpoint.py``),
with one pose ``[3]`` or a batch ``[..., 3]``, as those modules take them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from ..ops import gauss_newton, greedy_endpoint

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


# The greedy-endpoint tables, uploaded once per (config, device).
_kernel_tables = functools.lru_cache(maxsize=16)(
    greedy_endpoint.make_kernel_tables)


def cost_at(ccfg: CostConfig, prob, observed, ranges, angles, mask,
            sensor_pose, resolution, offset_xy, map_index=None):
    """Total cost at a map-local sensor pose (per candidate for batched
    poses, see ``ops/gauss_newton.py``)."""
    if ccfg.cost_type == COST_SQUARE_ERROR:
        return gauss_newton.cost(
            prob, observed, ranges, angles, mask, sensor_pose, resolution,
            offset_xy, map_index,
        )
    kx, ky, kc, kd = _kernel_tables(
        ccfg.kernel_size, resolution, ccfg.standard_deviation, prob.device
    )
    return greedy_endpoint.cost(
        prob, observed, ranges, angles, mask, sensor_pose, resolution,
        offset_xy, map_index,
        kernel_ox=kx, kernel_oy=ky, kernel_cost=kc, default_cost=kd,
        hit_and_missed_dist=ccfg.hit_and_missed_dist,
        occupancy_threshold=ccfg.occupancy_threshold,
        scaling_factor=ccfg.scaling_factor,
    )


def covariance_at(ccfg: CostConfig, prob, observed, ranges, angles, mask,
                  sensor_pose, resolution, offset_xy, map_index=None):
    """Pose covariance at a map-local sensor pose.

    SquareError: scale * H^{-1} (``cost_function_square_error.cpp:
    131-146``).  GreedyEndpoint: numeric-gradient g g^T + 0.1 I
    (``cost_function_greedy_endpoint.cpp:105-162``), its six perturbed
    poses scored in one call."""
    if ccfg.cost_type == COST_SQUARE_ERROR:
        return gauss_newton.covariance(
            prob, observed, ranges, angles, mask, sensor_pose, resolution,
            offset_xy, ccfg.covariance_scale, map_index,
        )

    def fn(p):  # p [..., 6, 3]: one more pose axis than the scan's
        return cost_at(ccfg, prob, observed, ranges[..., None, :],
                       angles[..., None, :], mask[..., None, :], p,
                       resolution, offset_xy[..., None, :], map_index)

    _, cov = greedy_endpoint.gradient_and_covariance(fn, sensor_pose,
                                                     resolution)
    return cov
