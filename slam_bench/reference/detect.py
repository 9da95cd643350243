"""Loop detection's verdict worked out again: the correlative search of
``scan_matcher_correlative.cpp`` over the whole pose window, in plain
PyTorch at a chosen dtype.

For a query scan and a finished local map, every pose of the search grid
around the query's initial sensor pose is scored: the x and y offsets
step by one cell over ``2 ceil(range / 2 res) / low_resolution + 1``
blocks of ``low_resolution`` cells from ``-ceil(range / 2 res)`` cells;
the angle steps by ``2 asin(res / 2 max_range)`` within ``range_theta /
2``, at most ``n_theta_max / 2`` steps each way.  A beam is counted where
its endpoint at the initial position falls inside the ``crop`` x
``crop`` cells that start two cells before the lowest endpoint over the
window's angles.  The score is the mean over the scan's beams of the
endpoint cells' probability (u8 / 255, an unobserved or outside cell 0),
the known rate the share of beams on observed cells.  A loop is found
where some pose scores above the score threshold on a block whose known
rate passes its threshold.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .gn import INV255


def search(prob_u8, observed, offset_xy, resolution, pose, ranges, angles,
           mask, d: dict, dtype=torch.float64, theta_chunk: int = 8):
    """(score, known) ``[thetas, ny, nx]`` over the search grid around the
    sensor pose ``pose`` (map frame); beams ``ranges``, ``angles`` with
    ``mask`` on the raster's device.  ``d``: the configuration's
    ``range_x``, ``range_y``, ``range_theta``, ``low_resolution``,
    ``n_theta_max`` and ``crop``."""
    dev = prob_u8.device
    res = resolution
    wx = int(math.ceil(0.5 * d["range_x"] / res))
    wy = int(math.ceil(0.5 * d["range_y"] / res))
    lr = d["low_resolution"]
    nx = ((2 * wx) // lr + 1) * lr
    ny = ((2 * wy) // lr + 1) * lr
    n_valid = max(1, int(mask.sum()))
    r = ranges[mask].to(dtype)
    a = angles[mask].to(dtype)
    step = 2.0 * math.asin(0.5 * res / float(r.max()))
    win_t = int(math.ceil(0.5 * d["range_theta"] / step))
    t0 = -min(win_t, d["n_theta_max"] // 2)
    t_idx = np.arange(t0, t0 + d["n_theta_max"])
    t_idx = t_idx[np.abs(t_idx) <= win_t]
    p = torch.as_tensor(np.asarray(pose, np.float64)).to(dev, dtype)
    th = p[2] + torch.as_tensor(t_idx, device=dev).to(dtype) * torch.tensor(
        step, dtype=torch.float64).to(dev, dtype)
    ang = th[:, None] + a[None, :]
    hx = p[0] + r * torch.cos(ang)
    hy = p[1] + r * torch.sin(ang)
    off = torch.as_tensor(np.asarray(offset_xy, np.float64)).to(dev, dtype)
    res_t = torch.tensor(res, dtype=torch.float64).to(dev, dtype)
    col = torch.floor((hx - off[0]) / res_t).long()
    row = torch.floor((hy - off[1]) / res_t).long()
    valid = ((row - (row.min() - 2) < d["crop"])
             & (col - (col.min() - 2) < d["crop"]))
    h, w = prob_u8.shape
    P = (prob_u8.to(torch.float32) * INV255).to(dtype).reshape(-1)
    O = observed.reshape(-1)
    oy = torch.arange(ny, device=dev) - wy
    ox = torch.arange(nx, device=dev) - wx
    scores, known = [], []
    for c in range(0, len(t_idx), theta_chunk):
        R = row[c:c + theta_chunk, None, None, :] + oy[None, :, None, None]
        C = col[c:c + theta_chunk, None, None, :] + ox[None, None, :, None]
        ok = ((R >= 0) & (R < h) & (C >= 0) & (C < w)
              & valid[c:c + theta_chunk, None, None, :])
        idx = R.clamp(0, h - 1) * w + C.clamp(0, w - 1)
        zero = torch.zeros((), dtype=dtype, device=dev)
        scores.append(torch.where(ok, P[idx], zero).sum(-1))
        known.append((ok & O[idx]).sum(-1))
    return (torch.cat(scores) / n_valid,
            torch.cat(known).to(dtype) / n_valid)


def verdict(score, known, d: dict, margin: float):
    """'found' where some pose passes both thresholds by ``margin``,
    'missed' where no pose scores within ``margin`` of the score
    threshold, else None (too near the thresholds to judge)."""
    s_thr, k_thr = d["score_threshold"], d["known_rate_threshold"]
    if bool(((score > s_thr + margin) & (known > k_thr + margin)).any()):
        return "found"
    if float(score.max()) <= s_thr - margin:
        return "missed"
    return None


def found(score, known, d: dict) -> bool:
    """Whether the search finds a loop at the thresholds themselves."""
    return bool(((score > d["score_threshold"])
                 & (known > d["known_rate_threshold"])).any())
