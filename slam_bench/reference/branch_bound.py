"""Branch-and-bound loop matching worked out again, exhaustively: every
pose of the window scored, the gates applied per pose, and the gated
maximum taken, in plain PyTorch.

The window is the one ``scan_matcher_branch_bound.cpp`` searches: the
angle steps by ``2 asin(res / 2 max_range)`` within ``range_theta / 2``,
at most ``n_theta_max / 2`` steps each way; the x and y offsets start
``ceil(range / 2 res)`` cells below the query and run over whole blocks
of ``2^h`` cells (``h = min(node_height_max, 3)``, at least 1) that cover
``2 ceil(range / 2 res) + 1`` cells, so they reach up to ``2^h - 1`` cells
past the window's high edge (-25 to +30 cells at the published 2.5 m
window).  A beam counts at an angle where its endpoint at the query's
position falls inside the ``crop`` x ``crop`` cells that start two cells
before the lowest endpoint over the window's angles.  A pose's score sum
is the u8 levels of its endpoint cells (0 off the map), its known count
the endpoints on observed cells; its score and known rate are those over
the scan's valid beams.  A pose is eligible where its known rate passes
the known-rate threshold; the match is the eligible pose of the largest
score sum, found where its score passes the score threshold.

The endpoint cells are the program's f32 geometry (trig in f64 rounded
once to f32, every other step in f32), so that a beam on a cell border
lands where the program puts it; the sums are exact integers in f64.

Where the maximum is tied, branch-and-bound keeps the first pose of the
first block in its bound order, which is no order of this search: there
only the score can be compared (``unique`` says which case holds).
"""
from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32


def _f32(x, dev):
    return torch.tensor(x, dtype=F32, device=dev)


def window(d: dict, resolution: float):
    """(wx, wy, nx, ny): the low corner's distance in cells and the number
    of offsets along x and y."""
    block = 1 << max(1, min(d["node_height_max"], 3))
    wx = int(math.ceil(0.5 * d["range_x"] / resolution))
    wy = int(math.ceil(0.5 * d["range_y"] / resolution))
    return wx, wy, ((2 * wx) // block + 1) * block, ((2 * wy) // block + 1) * block


def search(prob_u8, observed, offset_xy, resolution, pose, ranges, angles,
           mask, d: dict, theta_chunk: int = 8):
    """(score sums, known counts) f64 ``[thetas, ny, nx]`` over the window
    around the sensor pose ``pose`` (map frame, three f32 values), with
    the theta indices and the f32 theta step.  Beams ``ranges``,
    ``angles`` (f32) with ``mask`` on the raster's device; ``d`` holds
    ``range_x``, ``range_y``, ``range_theta``, ``node_height_max``,
    ``n_theta_max`` and ``crop``."""
    dev = prob_u8.device
    res = _f32(resolution, dev)
    r, a = ranges[mask].to(F32), angles[mask].to(F32)
    half = _f32(0.5, dev) * (res / r.max())
    step = _f32(2.0, dev) * torch.asin(half.double()).to(F32)
    win_t = int(torch.ceil(_f32(0.5 * d["range_theta"], dev) / step))
    t0 = -min(win_t, d["n_theta_max"] // 2)
    t_idx = np.arange(t0, t0 + d["n_theta_max"])
    t_idx = t_idx[np.abs(t_idx) <= win_t]
    p = torch.as_tensor(np.asarray(pose, np.float32)).to(dev)
    th = p[2] + torch.as_tensor(t_idx, device=dev).to(F32) * step
    ang = th[:, None] + a[None, :]
    hx = p[0] + r * torch.cos(ang.double()).to(F32)
    hy = p[1] + r * torch.sin(ang.double()).to(F32)
    off = torch.as_tensor(np.asarray(offset_xy, np.float32)).to(dev)
    col = torch.floor((hx - off[0]) / res).long()
    row = torch.floor((hy - off[1]) / res).long()
    valid = ((row - (row.min() - 2) < d["crop"])
             & (col - (col.min() - 2) < d["crop"]))
    wx, wy, nx, ny = window(d, resolution)
    h, w = prob_u8.shape
    P = prob_u8.to(torch.float64).reshape(-1)
    O = observed.reshape(-1)
    oy = torch.arange(ny, device=dev) - wy
    ox = torch.arange(nx, device=dev) - wx
    sums, known = [], []
    for c in range(0, len(t_idx), theta_chunk):
        R = row[c:c + theta_chunk, None, None, :] + oy[None, :, None, None]
        C = col[c:c + theta_chunk, None, None, :] + ox[None, None, :, None]
        ok = ((R >= 0) & (R < h) & (C >= 0) & (C < w)
              & valid[c:c + theta_chunk, None, None, :])
        idx = R.clamp(0, h - 1) * w + C.clamp(0, w - 1)
        sums.append(torch.where(ok, P[idx], 0.0).sum(-1))
        known.append((ok & O[idx]).sum(-1).to(torch.float64))
    return torch.cat(sums), torch.cat(known), t_idx, step


def match(prob_u8, observed, offset_xy, resolution, pose, ranges, angles,
          mask, d: dict) -> dict:
    """The gated maximum of :func:`search`: ``found``, ``score`` (-inf
    where no pose is eligible), ``pose`` (the winning sensor pose, f64),
    ``unique`` (whether one pose alone holds the maximum) and ``sum``
    (its score sum in u8 levels).  ``d`` also holds ``score_threshold``
    and ``known_rate_threshold``."""
    sums, known, t_idx, step = search(prob_u8, observed, offset_xy,
                                      resolution, pose, ranges, angles, mask,
                                      d)
    n = max(1, int(mask.sum()))
    elig = known / n > d["known_rate_threshold"]
    gated = torch.where(elig, sums, -math.inf)
    best = float(gated.max())
    score = best / 255.0 / n
    out = dict(found=score > d["score_threshold"], score=score, sum=best,
               unique=int((gated == best).sum()) == 1, pose=None)
    if best > -math.inf:
        t, j, i = np.unravel_index(int(torch.argmax(gated)), gated.shape)
        wx, wy, _, _ = window(d, resolution)
        p = np.asarray(pose, np.float64)
        out["pose"] = np.array([p[0] + (i - wx) * resolution,
                                p[1] + (j - wy) * resolution,
                                p[2] + t_idx[t] * float(step)])
    return out
