"""Carry the JAX package's configs and map state into the port.

SLAM has no learned weights: what both packages must share to be
compared are the configs and the maps.  These helpers take plain field
dicts (``dataclasses.asdict`` of the JAX configs) and NumPy arrays — never
JAX objects — and return the port's configs and device tensors.
"""
from __future__ import annotations

import numpy as np

from my_lidar_graph_slam_v2_tpu.matching.types import MapRaster

from .grid.builder import GridMapBuilderConfig
from .matching.correlative import CorrelativeConfig
from .matching.cost import CostConfig
from .matching.linear_solver import LinearSolverConfig
from .pipeline.frontend import FrontendConfig
from .utils.transfer import to_device


def correlative_config(fields: dict) -> CorrelativeConfig:
    fields = dict(fields)
    if fields.get("cost") is not None:
        fields["cost"] = CostConfig(**fields["cost"])
    return CorrelativeConfig(**fields)


def linear_solver_config(fields: dict) -> LinearSolverConfig:
    return LinearSolverConfig(**fields)


def builder_config(fields: dict) -> GridMapBuilderConfig:
    return GridMapBuilderConfig(**fields)


def frontend_config(fields: dict) -> FrontendConfig:
    fields = dict(fields)
    fields["initial_pose"] = tuple(fields["initial_pose"])
    return FrontendConfig(**fields)


def map_raster(prob, observed, offset_xy, resolution, device) -> MapRaster:
    """A matching raster from NumPy: ``prob`` as u8 levels, ``observed``
    as bools, and the raster offset."""
    return MapRaster(
        to_device(prob, device, np.uint8),
        to_device(observed, device, bool),
        float(resolution),
        np.asarray(offset_xy, np.float64),
    )


def fold_inputs(deltas, shifts, valid, offset_xy, max_shift, device,
                map_pose=None) -> dict:
    """The fused matcher's fold dict from NumPy fold inputs: S delta
    images ``[H, W]``, shifts ``[S, 2]``, valid ``[S]``."""
    out = dict(
        deltas=tuple(
            to_device(d, device, np.float32)
            for d in deltas
        ),
        shifts=np.asarray(shifts, np.int32),
        valid=np.asarray(valid, bool),
        offset_xy=np.asarray(offset_xy, np.float64),
        max_shift=int(max_shift),
    )
    if map_pose is not None:
        out["map_pose"] = np.asarray(map_pose, np.float64)
    return out
