"""Copy of ``my_lidar_graph_slam_v2_tpu/sensor/filters.py`` with its
``core.pose`` import pointed at the port's (NumPy) pose algebra; the
logic is unchanged.

Scan preprocessing filters.

Vectorized re-implementations of the reference's filter chain
(``mapping/scan_outlier_filter.cpp``, ``mapping/scan_interpolator.cpp``,
``mapping/scan_accumulator.cpp``): outlier removal by valid range, Cartesian
resampling to equalize inter-point spacing, and multi-scan accumulation by
re-projecting older beams into the latest sensor frame.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from ..core import pose as P
from .data import ScanData


@dataclass
class ScanOutlierFilter:
    """Drop beams with range outside (valid_min, valid_max) —
    ``scan_outlier_filter.cpp:20-72``."""

    valid_range_min: float = 0.01
    valid_range_max: float = 20.0

    def remove_outliers(self, scan: ScanData) -> ScanData:
        keep = (self.valid_range_min < scan.ranges) & (
            scan.ranges < self.valid_range_max
        )
        ranges = scan.ranges[keep]
        angles = scan.angles[keep]
        if len(ranges) == 0:
            ranges = np.array([self.valid_range_min])
            angles = np.array([0.0])
        return scan.copy_with(
            ranges=ranges,
            angles=angles,
            min_range=max(scan.min_range, self.valid_range_min),
            max_range=min(scan.max_range, self.valid_range_max),
            min_angle=float(angles.min()),
            max_angle=float(angles.max()),
        )


@dataclass
class ScanInterpolator:
    """Resample beams in Cartesian space so adjacent points are ``dist_scans``
    apart, skipping empty gaps > ``dist_threshold_empty`` —
    ``scan_interpolator.cpp:10-94``. Sequential by nature; runs on host.
    """

    dist_scans: float = 0.05
    dist_threshold_empty: float = 0.25

    def interpolate(self, scan: ScanData) -> ScanData:
        px = scan.ranges * np.cos(scan.angles)
        py = scan.ranges * np.sin(scan.angles)
        n = len(px)
        out_x = [px[0]]
        out_y = [py[0]]
        prev_x, prev_y = px[0], py[0]
        accum = 0.0
        i = 1
        while i < n:
            dist = float(np.hypot(px[i] - prev_x, py[i] - prev_y))
            if accum + dist < self.dist_scans:
                accum += dist
                prev_x, prev_y = px[i], py[i]
                i += 1
            elif accum + dist >= self.dist_threshold_empty:
                out_x.append(px[i])
                out_y.append(py[i])
                prev_x, prev_y = px[i], py[i]
                accum = 0.0
                i += 1
            else:
                ratio = (self.dist_scans - accum) / dist
                sx = (px[i] - prev_x) * ratio + prev_x
                sy = (py[i] - prev_y) * ratio + prev_y
                out_x.append(sx)
                out_y.append(sy)
                prev_x, prev_y = sx, sy
                accum = 0.0
                # reference reprocesses the current point
        out_x = np.asarray(out_x)
        out_y = np.asarray(out_y)
        ranges = np.hypot(out_x, out_y)
        angles = np.arctan2(out_y, out_x)
        return scan.copy_with(
            ranges=ranges,
            angles=angles,
            min_range=float(ranges.min()),
            max_range=float(ranges.max()),
            min_angle=float(angles.min()),
            max_angle=float(angles.max()),
        )


class ScanAccumulator:
    """Concatenate recent scans into one virtual scan by re-projecting
    older beams into the latest sensor frame (law of cosines) —
    ``scan_accumulator.cpp:26-127``. Off by default in the reference."""

    def __init__(self, num_accumulated_scans: int = 3):
        self.num = num_accumulated_scans
        self._scans: deque[ScanData] = deque()

    def append_scan(self, scan: ScanData):
        self._scans.appendleft(scan)
        while len(self._scans) > self.num:
            self._scans.pop()

    def compute_concatenated_scan(self) -> ScanData:
        assert self._scans
        latest = self._scans.popleft()
        if not self._scans:
            return latest
        latest_sensor = P.compound(latest.odom_pose, latest.relative_sensor_pose)
        all_ranges = [latest.ranges]
        all_angles = [latest.angles]
        n_prev = min(len(self._scans), self.num - 1)
        for k in range(n_prev):
            s = self._scans[k]
            sensor = P.compound(s.odom_pose, s.relative_sensor_pose)
            rel = P.inverse_compound(sensor, latest_sensor)
            r, a = s.ranges, s.angles
            ca, sa = np.cos(a), np.sin(a)
            new_r = np.sqrt(
                r * r + rel[0] ** 2 + rel[1] ** 2 - 2.0 * r * (rel[0] * ca + rel[1] * sa)
            )
            sx = r * ca - rel[0]
            sy = r * sa - rel[1]
            new_a = P.normalize_angle(np.arctan2(sy, sx) - rel[2])
            all_ranges.append(new_r)
            all_angles.append(new_a)
        self._scans.clear()
        ranges = np.concatenate(all_ranges)
        angles = np.concatenate(all_angles)
        order = np.argsort(angles, kind="stable")
        ranges, angles = ranges[order], angles[order]
        return latest.copy_with(
            ranges=ranges,
            angles=angles,
            min_range=float(ranges.min()),
            max_range=float(ranges.max()),
            min_angle=float(angles.min()),
            max_angle=float(angles.max()),
        )
