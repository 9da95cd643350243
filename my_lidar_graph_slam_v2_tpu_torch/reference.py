"""Carry the JAX package's configs and map state into the port.

SLAM has no learned weights: what both packages must share to be
compared are the configs and the maps.  These helpers take plain field
dicts (``dataclasses.asdict`` of the JAX configs) and NumPy arrays — never
JAX objects — and return the port's configs and device tensors.
"""
from __future__ import annotations

import numpy as np

from .graph.loss import LossFunction
from .graph.optimizer import OptimizerConfig
from .grid.builder import GridMapBuilderConfig, LocalMap
from .grid.counted import GridCounted
from .matching.branch_bound import BranchBoundConfig
from .matching.correlative import CorrelativeConfig
from .matching.cost import CostConfig
from .matching.grid_search import GridSearchConfig
from .matching.hill_climbing import HillClimbingConfig
from .matching.linear_solver import LinearSolverConfig
from .matching.types import MapRaster, ScanArrays
from .pipeline.frontend import FrontendConfig
from .utils.transfer import to_device


def _with_cost(config_cls, fields: dict):
    fields = dict(fields)
    if fields.get("cost") is not None:
        fields["cost"] = CostConfig(**fields["cost"])
    return config_cls(**fields)


def correlative_config(fields: dict) -> CorrelativeConfig:
    return _with_cost(CorrelativeConfig, fields)


def branch_bound_config(fields: dict) -> BranchBoundConfig:
    return _with_cost(BranchBoundConfig, fields)


def grid_search_config(fields: dict) -> GridSearchConfig:
    return _with_cost(GridSearchConfig, fields)


def hill_climbing_config(fields: dict) -> HillClimbingConfig:
    return _with_cost(HillClimbingConfig, fields)


def optimizer_config(fields: dict) -> OptimizerConfig:
    fields = dict(fields)
    fields["loss"] = LossFunction(**fields["loss"])
    return OptimizerConfig(**fields)


def linear_solver_config(fields: dict) -> LinearSolverConfig:
    return LinearSolverConfig(**fields)


def builder_config(fields: dict) -> GridMapBuilderConfig:
    return GridMapBuilderConfig(**fields)


def frontend_config(fields: dict) -> FrontendConfig:
    fields = dict(fields)
    fields["initial_pose"] = tuple(fields["initial_pose"])
    return FrontendConfig(**fields)


def map_raster(prob, observed, offset_xy, resolution, device) -> MapRaster:
    """A matching raster from NumPy: ``prob`` as f32 probabilities if it
    is a float array, else as u8 levels; ``observed`` as bools, and the
    raster offset."""
    floating = np.issubdtype(np.asarray(prob).dtype, np.floating)
    return MapRaster(
        to_device(prob, device, np.float32 if floating else np.uint8),
        to_device(observed, device, bool),
        float(resolution),
        np.asarray(offset_xy, np.float64),
    )


def scan_arrays(ranges, angles, mask, device, *, rel_sensor_pose, num_valid,
                max_range=0.0) -> ScanArrays:
    """A port scan from NumPy beams: ``ranges``, ``angles`` f32 and
    ``mask`` bool ``[B]``, with the host-side metadata."""
    return ScanArrays(
        to_device(ranges, device, np.float32),
        to_device(angles, device, np.float32),
        to_device(mask, device, bool),
        np.asarray(rel_sensor_pose), int(num_valid), float(max_range),
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


def local_map(local_map_id, offset_xy, device, *, logodds=None,
              observed=None, prob_q=None, version=0,
              finished=True) -> LocalMap:
    """A port LocalMap from NumPy map state: either a live f32 ``logodds``
    raster or a compacted u8 ``prob_q`` raster, with its ``observed``
    mask (the state ``grid/map_cache.py`` reads)."""
    compacted = prob_q is not None
    return LocalMap(
        local_map_id,
        None if compacted else to_device(logodds, device, np.float32),
        to_device(observed, device, bool),
        np.asarray(offset_xy, np.float64),
        scan_node_id_min=0, scan_node_id_max=0, finished=finished,
        version=version,
        prob_q=to_device(prob_q, device, np.uint8) if compacted else None,
        compacted=compacted,
    )


def grid_counted(hits, counts, device) -> GridCounted:
    """A port GridCounted holding a JAX GridCounted's planes, given as
    NumPy int32 ``[rows, cols]`` arrays."""
    g = GridCounted(hits.shape[0], hits.shape[1], device)
    g.hits = to_device(hits, device, np.int32)
    g.counts = to_device(counts, device, np.int32)
    return g
