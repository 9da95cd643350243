"""Occupancy rasters in plain PyTorch: the configuration's map semantics
(``grid_map_builder.cpp``), worked out again from the scans and the
poses a map was built at.

A scan adds ``logodds_miss`` once to every cell its beam passes through,
found from ``samples`` points spaced evenly along the beam and counted
once per cell a beam enters (never at its hit cell), and ``logodds_hit``
once per hit cell; the sum is clipped to [ln(0.001/0.999),
ln(0.999/0.001)] in one Bayes step per scan.  A matching raster stores
``round(255 p)`` (0 unknown).  The rolling latest map is the fold of the
last scans, each drawn in an axis-aligned frame at its own cell corner and
moved by whole cells to the first one's.

Coordinates are computed in ``dtype``: float32, the configuration's
precision, with every division by a 0-d tensor (IEEE on every device);
the benchmark's control passes bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from . import filters
from .pose import compound, inverse_compound

LOGODDS_MIN = float(np.log(1e-3 / (1.0 - 1e-3)))
LOGODDS_MAX = float(np.log((1.0 - 1e-3) / 1e-3))


def logodds(p: float) -> float:
    return float(np.log(p / (1 - p)))


def _scalar(x, device, dtype):
    return torch.full((), x, dtype=dtype, device=device)


def local_hits(map_pose, node_pose, scan, m):
    """(sensor xy, hit points, usable mask) of ``scan`` taken at
    ``node_pose``, in the frame of ``map_pose``; f64 on the host."""
    g_sensor = compound(node_pose, scan["relative_sensor_pose"])
    l_sensor = inverse_compound(map_pose, g_sensor)
    r, a, mask = filters.pad_scan(scan, m["beam_capacity"],
                                  m["usable_range_min"], m["usable_range_max"])
    ang = l_sensor[2] + a
    hits = np.stack([l_sensor[0] + r * np.cos(ang),
                     l_sensor[1] + r * np.sin(ang)], -1)
    return l_sensor[:2], hits, mask


def _cells(p, res, off):
    rc = torch.floor(torch.div(p - off, res)).to(torch.int32)
    return rc[..., 1], rc[..., 0]


def scan_delta(shape, sensor_xy, hits_xy, mask, offset_xy, m, device,
               dtype=torch.float32):
    """The raw log-odds change one scan makes to an ``shape`` raster whose
    cell (0, 0) has its corner at ``offset_xy``."""
    h, w = shape
    res = _scalar(m["resolution"], device, dtype)
    s = torch.as_tensor(np.asarray(sensor_xy, np.float32), device=device
                        ).to(dtype)
    hx = torch.as_tensor(np.asarray(hits_xy, np.float32), device=device
                         ).to(dtype)
    off = torch.as_tensor(np.asarray(offset_xy, np.float32), device=device
                          ).to(dtype)
    mask = torch.as_tensor(mask, device=device)
    k = m["samples_per_beam"]
    d = hx - s[None, :]
    t = torch.div(torch.arange(k, dtype=dtype, device=device) + 0.5,
                  _scalar(k, device, dtype))
    pts = s[None, None, :] + d[:, None, :] * t[None, :, None]
    rows, cols = _cells(pts, res, off)
    hit_r, hit_c = _cells(hx, res, off)
    entered = torch.ones(rows.shape, dtype=torch.bool, device=device)
    entered[:, 1:] = (rows[:, 1:] != rows[:, :-1]) | (cols[:, 1:] != cols[:, :-1])
    at_hit = (rows == hit_r[:, None]) & (cols == hit_c[:, None])
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    miss = mask[:, None] & entered & ~at_hit & inside
    # Counted inside a crop x crop window at the valid samples' low corner.
    crop = min(m["rasterize_crop"], h, w)
    big = 1 << 30
    r0 = int(torch.clamp(torch.where(miss, rows, big).min(), 0, h - crop))
    c0 = int(torch.clamp(torch.where(miss, cols, big).min(), 0, w - crop))
    miss = miss & (rows >= r0) & (rows < r0 + crop) & (cols >= c0) & (cols < c0 + crop)
    counts = torch.zeros(h * w, dtype=torch.int32, device=device)
    counts.index_add_(0, (rows.long() * w + cols.long())[miss],
                      torch.ones(int(miss.sum()), dtype=torch.int32,
                                 device=device))
    delta = counts.to(torch.float32) * float(np.float32(logodds(m["probability_miss"])))
    hit_ok = mask & (hit_r >= 0) & (hit_r < h) & (hit_c >= 0) & (hit_c < w)
    idx = (hit_r.long() * w + hit_c.long())[hit_ok]
    delta.index_add_(0, idx, torch.full(idx.shape, float(np.float32(
        logodds(m["probability_hit"]))), dtype=torch.float32, device=device))
    return delta.reshape(h, w)


def bayes_step(lo, obs, delta):
    touched = delta != 0.0
    new = torch.clamp(torch.where(obs, lo, 0.0) + delta, LOGODDS_MIN,
                      LOGODDS_MAX)
    return torch.where(touched, new, lo), obs | touched


def quantize(lo, obs):
    """u8 matching raster: round(255 p), round half to even; 0 unknown."""
    p = torch.where(obs, torch.sigmoid(lo), 0.0)
    return torch.round(p * 255.0).to(torch.uint8)


def map_offset(rows, cols, res):
    return np.array([-res * (cols // 2), -res * (rows // 2)])


def rasterize_calls(calls, scans, m, device, dtype=torch.float32):
    """A local map's (log-odds, observed) from its integration calls: each
    ``(map_pose, [(node_id, node_pose), ...])``, the scans in order."""
    h, w = m["map_rows"], m["map_cols"]
    off = map_offset(h, w, m["resolution"])
    lo = torch.zeros((h, w), dtype=torch.float32, device=device)
    obs = torch.zeros((h, w), dtype=torch.bool, device=device)
    for map_pose, entries in calls:
        for node_id, node_pose in entries:
            s, hx, mask = local_hits(map_pose, node_pose, scans[node_id], m)
            lo, obs = bayes_step(lo, obs, scan_delta(
                (h, w), s, hx, mask, off, m, device, dtype))
    return lo, obs


def _shift(delta, dr, dc):
    """``out[r, c] = delta[r - dr, c - dc]``, zero where that falls off."""
    h, w = delta.shape
    out = torch.zeros_like(delta)
    if abs(dr) < h and abs(dc) < w:
        out[max(dr, 0):h + min(dr, 0), max(dc, 0):w + min(dc, 0)] = delta[
            max(-dr, 0):h - max(dr, 0), max(-dc, 0):w - max(dc, 0)]
    return out


def latest_map(window, scans, m, device, dtype=torch.float32):
    """The rolling latest map over ``window`` ([(node_id, node_pose)],
    oldest first): (u8 raster, observed, map pose, offset), or None where
    the window spreads beyond the shift pad (the matcher then takes
    another path, which this reference does not judge)."""
    res = m["resolution"]
    h, w = m["map_rows"], m["map_cols"]
    off = map_offset(h, w, res)
    pad = m["latest_map_shift_pad"]
    anchor = np.floor(np.asarray(window[0][1])[:2] / res).astype(np.int64)
    lo = torch.zeros((h, w), dtype=torch.float32, device=device)
    obs = torch.zeros((h, w), dtype=torch.bool, device=device)
    for node_id, pose in window:
        cell = np.floor(np.asarray(pose)[:2] / res).astype(np.int64)
        dr, dc = int(cell[1] - anchor[1]), int(cell[0] - anchor[0])
        if abs(dr) > pad or abs(dc) > pad:
            return None
        corner = np.array([cell[0] * res, cell[1] * res, 0.0])
        s, hx, mask = local_hits(corner, pose, scans[node_id], m)
        delta = scan_delta((h, w), s, hx, mask, off, m, device, dtype)
        lo, obs = bayes_step(lo, obs, _shift(delta, dr, dc))
    map_pose = np.array([anchor[0] * res, anchor[1] * res, 0.0])
    return quantize(lo, obs), obs, map_pose, off

