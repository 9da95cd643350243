# The port's own copy of my_lidar_graph_slam_v2_tpu/grid/geometry.py, logic
# unchanged: the port imports nothing of the JAX package.
"""Grid map geometry: index <-> position conversion with a position offset.

Mirrors ``grid_map_new/grid_map_geometry.{hpp,cpp}`` of the reference:
``PositionToIndex`` floors ``(pos - offset) / resolution``; cell (row, col)
covers the half-open square ``[offset + res*col, offset + res*(col+1))``.

Unlike the reference's dynamically-resizable geometry, the TPU maps are
fixed-shape ``[rows, cols]`` rasters whose offset is chosen once at map
creation (anchored so the expected scan content fits); this is the
"pre-sized extent policy" for device-resident local maps (SURVEY.md section
7, hard part 3).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class GridGeometry:
    resolution: float
    rows: int
    cols: int
    offset_x: float
    offset_y: float

    @property
    def width(self) -> float:
        return self.resolution * self.cols

    @property
    def height(self) -> float:
        return self.resolution * self.rows

    def position_to_index(self, x, y):
        """Floor conversion; returns (row, col) arrays (int32)."""
        col = np.floor((np.asarray(x) - self.offset_x) / self.resolution)
        row = np.floor((np.asarray(y) - self.offset_y) / self.resolution)
        return row.astype(np.int32), col.astype(np.int32)

    def position_to_index_f(self, x, y):
        """Fractional index (row, col) as floats — ``PositionToIndexF``."""
        col = (np.asarray(x) - self.offset_x) / self.resolution
        row = (np.asarray(y) - self.offset_y) / self.resolution
        return row, col

    def index_to_position(self, row, col):
        """Cell corner position — ``IndexToPosition``."""
        x = self.offset_x + self.resolution * np.asarray(col)
        y = self.offset_y + self.resolution * np.asarray(row)
        return x, y

    def is_index_inside(self, row, col):
        return (
            (np.asarray(row) >= 0)
            & (np.asarray(row) < self.rows)
            & (np.asarray(col) >= 0)
            & (np.asarray(col) < self.cols)
        )

    def scaled(self, subpixel_scale: int) -> "GridGeometry":
        """Subpixel geometry — ``GridMapGeometry::ScaledGeometry``."""
        return replace(
            self,
            resolution=self.resolution / subpixel_scale,
            rows=self.rows * subpixel_scale,
            cols=self.cols * subpixel_scale,
        )

    @staticmethod
    def centered(
        resolution: float, rows: int, cols: int, center_x: float, center_y: float
    ) -> "GridGeometry":
        """Geometry whose raster is centered on a given map-local position."""
        off_x = center_x - resolution * (cols // 2)
        off_y = center_y - resolution * (rows // 2)
        return GridGeometry(resolution, rows, cols, off_x, off_y)
