"""The reference's scan filter chain on plain NumPy scans: outlier removal
by valid range (``scan_outlier_filter.cpp``), then Cartesian resampling to
``dist_scans`` spacing (``scan_interpolator.cpp``).  A frozen copy of the
plain formulas; a scan here is a dict with ``ranges``, ``angles``,
``min_range`` and ``max_range``, which is all the map and the matchers
read."""
from __future__ import annotations

import numpy as np


def remove_outliers(scan: dict, valid_min: float, valid_max: float) -> dict:
    keep = (valid_min < scan["ranges"]) & (scan["ranges"] < valid_max)
    ranges = scan["ranges"][keep]
    angles = scan["angles"][keep]
    if len(ranges) == 0:
        ranges = np.array([valid_min])
        angles = np.array([0.0])
    return dict(scan, ranges=ranges, angles=angles,
                min_range=max(scan["min_range"], valid_min),
                max_range=min(scan["max_range"], valid_max))


def interpolate(scan: dict, dist_scans: float, dist_threshold_empty: float
                ) -> dict:
    """Resample so that adjacent points lie ``dist_scans`` apart, skipping
    gaps of ``dist_threshold_empty`` or more; the current point is taken
    again after an inserted one, as the reference does."""
    px = scan["ranges"] * np.cos(scan["angles"])
    py = scan["ranges"] * np.sin(scan["angles"])
    n = len(px)
    out_x, out_y = [px[0]], [py[0]]
    prev_x, prev_y = px[0], py[0]
    accum = 0.0
    i = 1
    while i < n:
        dist = float(np.hypot(px[i] - prev_x, py[i] - prev_y))
        if accum + dist < dist_scans:
            accum += dist
            prev_x, prev_y = px[i], py[i]
            i += 1
        elif accum + dist >= dist_threshold_empty:
            out_x.append(px[i])
            out_y.append(py[i])
            prev_x, prev_y = px[i], py[i]
            accum = 0.0
            i += 1
        else:
            ratio = (dist_scans - accum) / dist
            sx = (px[i] - prev_x) * ratio + prev_x
            sy = (py[i] - prev_y) * ratio + prev_y
            out_x.append(sx)
            out_y.append(sy)
            prev_x, prev_y = sx, sy
            accum = 0.0
    out_x = np.asarray(out_x)
    out_y = np.asarray(out_y)
    ranges = np.hypot(out_x, out_y)
    angles = np.arctan2(out_y, out_x)
    return dict(scan, ranges=ranges, angles=angles,
                min_range=float(ranges.min()), max_range=float(ranges.max()))


def filtered(scan: dict, cfg: dict) -> dict:
    """The frontend's chain as the configuration states it."""
    if cfg["use_outlier_filter"]:
        scan = remove_outliers(scan, cfg["valid_range_min"],
                               cfg["valid_range_max"])
    if cfg["use_interpolator"]:
        scan = interpolate(scan, cfg["dist_scans"],
                           cfg["dist_threshold_empty"])
    return scan


def pad_scan(scan: dict, capacity: int, usable_min: float,
             usable_max: float):
    """Padded f32 (ranges, angles) and the usable-range mask; a uniform
    subsample where the scan holds more beams than ``capacity``."""
    min_range = max(usable_min, scan["min_range"])
    max_range = min(usable_max, scan["max_range"])
    ranges, angles = scan["ranges"], scan["angles"]
    n = len(ranges)
    if n > capacity:
        idx = np.linspace(0, n - 1, capacity).astype(int)
        ranges, angles = ranges[idx], angles[idx]
        n = capacity
    valid = (ranges > min_range) & (ranges < max_range)
    r = np.zeros(capacity, np.float32)
    a = np.zeros(capacity, np.float32)
    m = np.zeros(capacity, bool)
    r[:n] = ranges
    a[:n] = angles
    m[:n] = valid
    return r, a, m
