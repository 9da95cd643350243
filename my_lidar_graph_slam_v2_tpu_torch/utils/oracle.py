# The port's own copy of my_lidar_graph_slam_v2_tpu/utils/oracle.py, logic
# unchanged: the port imports nothing of the JAX package.
"""NumPy reference oracles used to validate the TPU kernels.

These re-state the reference semantics in plain NumPy and are used only by
tests and as CPU baselines for the benchmark harness:

* ``traverse_pixels`` — the pixel set crossed by a continuous segment,
  equivalent to the reference's subpixel Bresenham
  (``src/my_lidar_graph_slam/bresenham.cpp:58+``, itself adapted from
  Cartographer's ray-to-pixel mask) at subpixel scale 100: each full pixel
  traversed by the segment between the subpixel centers is visited once, in
  order.
* ``integrate_scan_oracle`` — sequential odds-space map update with u16
  quantization after every update (``grid_binary_bayes.cpp:302-321`` and
  ``grid_map_builder.cpp:390-494``).
* ``sliding_window_max`` — monotonic-deque max filter
  (``util.hpp:370-420``); output[i] = max(input[i : i + win]).
* ``score_pixel_accurate_oracle`` / ``correlative_search_oracle`` — the CSM
  scoring loops (``score_function_pixel_accurate.cpp:16-58`` and
  ``scan_matcher_correlative.cpp:118-368``).
"""
from __future__ import annotations

import numpy as np

from ..grid import values as gv

SUBPIXEL_SCALE = 100


def _subpixel_center(pos, offset, resolution, scale=SUBPIXEL_SCALE):
    """Continuous coordinate of the subpixel center containing ``pos``,
    in units of full pixels relative to the raster offset."""
    sub_res = resolution / scale
    idx = np.floor((pos - offset) / sub_res)
    return (idx + 0.5) / scale


def traverse_pixels(x0, y0, x1, y1):
    """All integer pixels crossed by the segment (x0,y0)->(x1,y1), where
    coordinates are continuous in pixel units (pixel (i,j) spans
    [i, i+1) x [j, j+1)).  Amanatides-Woo traversal; each pixel once."""
    px, py = int(np.floor(x0)), int(np.floor(y0))
    ex, ey = int(np.floor(x1)), int(np.floor(y1))
    pixels = [(px, py)]
    dx, dy = x1 - x0, y1 - y0
    step_x = 1 if dx > 0 else -1
    step_y = 1 if dy > 0 else -1
    # Parametric distance to the next vertical/horizontal pixel border
    if dx != 0:
        t_max_x = ((px + (step_x > 0)) - x0) / dx
        t_dx = abs(1.0 / dx)
    else:
        t_max_x, t_dx = np.inf, np.inf
    if dy != 0:
        t_max_y = ((py + (step_y > 0)) - y0) / dy
        t_dy = abs(1.0 / dy)
    else:
        t_max_y, t_dy = np.inf, np.inf
    while (px, py) != (ex, ey):
        if t_max_x < t_max_y:
            px += step_x
            t_max_x += t_dx
        else:
            py += step_y
            t_max_y += t_dy
        pixels.append((px, py))
        if len(pixels) > 100000:  # safety
            raise RuntimeError("ray traversal did not terminate")
    return pixels


def missed_cells(sensor_xy, hit_xy, geometry, scale=SUBPIXEL_SCALE):
    """Free-space cells for one beam: traversed pixels minus the hit pixel.

    Mirrors ``GridMapBuilder::ComputeMissedIndicesScaled``
    (``grid_map_builder.cpp:893-915``): subpixel-quantized endpoints, each
    traversed full pixel once, the end (hit) pixel removed.
    """
    x0 = _subpixel_center(sensor_xy[0], geometry.offset_x, geometry.resolution, scale)
    y0 = _subpixel_center(sensor_xy[1], geometry.offset_y, geometry.resolution, scale)
    x1 = _subpixel_center(hit_xy[0], geometry.offset_x, geometry.resolution, scale)
    y1 = _subpixel_center(hit_xy[1], geometry.offset_y, geometry.resolution, scale)
    pix = traverse_pixels(x0, y0, x1, y1)
    end = (int(np.floor(x1)), int(np.floor(y1)))
    out = [p for p in pix if p != end]
    return out


def update_odds_u16(value, odds):
    """One Bayes update of a u16 cell — ``grid_binary_bayes.cpp:302-321``."""
    if value == gv.UNKNOWN_VALUE:
        return gv.prob_to_value(gv.odds_to_prob(odds))
    old_odds = gv.prob_to_odds(gv.value_to_prob(value))
    return gv.prob_to_value(gv.odds_to_prob(old_odds * odds))


def integrate_scan_oracle(
    values_u16,
    geometry,
    sensor_xy,
    hit_points,
    odds_hit,
    odds_miss,
    scale=SUBPIXEL_SCALE,
):
    """Integrate one scan into a u16 map in-place, reference-faithfully.

    ``hit_points`` is an (N, 2) array of map-local hit positions that have
    already passed the usable-range filter. Out-of-raster cells are skipped
    (the reference expands the map instead; the TPU raster is pre-sized)."""
    rows, cols = values_u16.shape
    for hx, hy in hit_points:
        for cx, cy in missed_cells(sensor_xy, (hx, hy), geometry, scale):
            if 0 <= cy < rows and 0 <= cx < cols:
                values_u16[cy, cx] = update_odds_u16(values_u16[cy, cx], odds_miss)
        r, c = geometry.position_to_index(hx, hy)
        if 0 <= r < rows and 0 <= c < cols:
            values_u16[r, c] = update_odds_u16(values_u16[r, c], odds_hit)
    return values_u16


def sliding_window_max(arr, win):
    """1D sliding max: out[i] = max(arr[i : i + win]) with edge repeat.

    Matches ``SlidingWindowMax`` (``util.hpp:370-420``) which repeats the
    max of the final (shrinking) window for the last elements."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    out = np.empty_like(arr)
    for i in range(n):
        out[i] = arr[i : min(i + win, n)].max()
    return out


def precompute_map_oracle(values_u16, win):
    """2D sliding-window max (window anchored at the cell, extending to
    higher indices) — ``grid_map_builder.cpp:917-1065``."""
    tmp = np.empty_like(values_u16)
    for c in range(values_u16.shape[1]):
        tmp[:, c] = sliding_window_max(values_u16[:, c], win)
    out = np.empty_like(values_u16)
    for r in range(values_u16.shape[0]):
        out[r, :] = sliding_window_max(tmp[r, :], win)
    return out


def score_pixel_accurate_oracle(prob_map, rows, cols, num_scans):
    """Score from precomputed per-beam cell indices.

    ``prob_map`` stores probabilities with 0.0 = unknown. Out-of-bounds
    indices contribute unknown. Returns (normalized_score, known_rate)."""
    h, w = prob_map.shape
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    probs = np.where(inside, prob_map[np.clip(rows, 0, h - 1), np.clip(cols, 0, w - 1)], 0.0)
    known = probs != 0.0
    return probs.sum() / num_scans, known.sum() / num_scans


def correlative_search_oracle(
    prob_fine,
    prob_coarse,
    geometry,
    beam_ranges,
    beam_angles,
    sensor_pose,
    range_x,
    range_y,
    range_theta,
    low_resolution,
    score_threshold=0.0,
    known_rate_threshold=0.0,
):
    """Faithful re-statement of ``ScanMatcherCorrelative::OptimizePose``
    (``scan_matcher_correlative.cpp:116-368``): coarse stride sweep with
    running-max pruning, fine refinement over [x, x+lowres) blocks,
    first-in-(t,x,y)-order tie break.  Returns
    (best_pose, best_score, found, step, win)."""
    res = geometry.resolution
    max_range = beam_ranges.max()
    tt = res / max_range
    step_theta = np.arccos(1.0 - 0.5 * tt * tt)
    win_x = int(np.ceil(0.5 * range_x / res))
    win_y = int(np.ceil(0.5 * range_y / res))
    win_t = int(np.ceil(0.5 * range_theta / step_theta))
    n = len(beam_ranges)

    best = (-win_x, -win_y, -win_t)
    score_max = score_threshold
    for t in range(-win_t, win_t + 1):
        th = sensor_pose[2] + step_theta * t
        hx = sensor_pose[0] + beam_ranges * np.cos(th + beam_angles)
        hy = sensor_pose[1] + beam_ranges * np.sin(th + beam_angles)
        rows, cols = geometry.position_to_index(hx, hy)
        for x in range(-win_x, win_x + 1, low_resolution):
            for y in range(-win_y, win_y + 1, low_resolution):
                s, kr = score_pixel_accurate_oracle(
                    prob_coarse, rows + y, cols + x, n
                )
                if s <= score_max or kr <= known_rate_threshold:
                    continue
                for fx in range(x, x + low_resolution):
                    for fy in range(y, y + low_resolution):
                        fs, _ = score_pixel_accurate_oracle(
                            prob_fine, rows + fy, cols + fx, n
                        )
                        if score_max < fs:
                            score_max = fs
                            best = (fx, fy, t)
    found = score_max > score_threshold
    bx, by, bt = best
    best_pose = np.array(
        [
            sensor_pose[0] + bx * res,
            sensor_pose[1] + by * res,
            sensor_pose[2] + bt * step_theta,
        ]
    )
    return best_pose, score_max, found, (res, res, step_theta), (win_x, win_y, win_t)
