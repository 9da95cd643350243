"""Scan -> occupancy-map integration on the device.

Port of ``my_lidar_graph_slam_v2_tpu/ops/rasterize.py``
(``grid_map_builder.cpp:390-494``).  Maps are ``[H, W]`` f32 log-odds
rasters plus a bool observed mask; a scan's update is a raw delta image
(``scan_delta``) folded in with a clipped Bayes step (``_apply_delta``).

Free-space cells come from ``K`` samples per beam; each beam gives at
most one miss per traversed cell and none at its hit cell.  Two backends,
the JAX package's names:

- ``"matmul"`` (the builder's default): exact int32 miss counts over the
  cells, then ONE multiply by ``logodds_miss``, as the JAX package's
  one-hot count images times the weight; including its crop window:
  samples beyond ``crop`` cells of the valid-sample bounding box's low
  corner are not counted.
- ``"scatter"``: ``logodds_miss`` added once per valid miss sample over
  the whole raster (no crop), as the JAX scatter.

Hit cells then add ``logodds_hit`` once per valid hit onto the miss image,
as the JAX scatter does.  Every addend of one ``index_add_`` is the same
f32 value, so every order of the adds (the CPU's loop, CUDA's atomics)
performs the same sequence of roundings and gives the sequential sum: both
backends equal the JAX package's bit for bit where the sample cells agree,
on either device.  Unlike the JAX functions, whose default is
``"scatter"``, :func:`scan_delta` and :func:`integrate_scans` default to
the builder's ``"matmul"``.

Out-of-range cells are masked and routed explicitly: torch indexing does
not clamp or drop the way XLA gathers and scatters do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import values as gv
from ..utils.transfer import f32

DEFAULT_SAMPLES_PER_BEAM = 768


def _cell_of(p, res, off):
    """[..., 2] map-local points -> (row, col) i32 cells."""
    rc = torch.floor(torch.div(p - off, res)).to(torch.int32)
    return rc[..., 1], rc[..., 0]


def _flat_index(rows, cols, keep, h, w):
    """Flat cell index of each kept (row, col), ``h * w`` (a spare slot
    past the raster) for the others, so no mask goes through the host."""
    return torch.where(keep, rows.long() * w + cols.long(), h * w).reshape(-1)


def _count_cells(rows, cols, keep, h, w):
    """int32 [h, w] image counting the kept (row, col) cells."""
    idx = _flat_index(rows, cols, keep, h, w)
    counts = torch.zeros(h * w + 1, dtype=torch.int32, device=rows.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[: h * w].reshape(h, w)


def _add_per_cell(image, rows, cols, keep, value):
    """``image`` with the f32 ``value`` added once per kept (row, col), as
    a scatter adds it: every addend is equal, so the sum does not depend
    on the order of the adds."""
    h, w = image.shape
    idx = _flat_index(rows, cols, keep, h, w)
    flat = torch.cat([image.reshape(-1), image.new_zeros(1)])
    flat.index_add_(0, idx, torch.full(idx.shape, float(np.float32(value)),
                                       dtype=torch.float32, device=idx.device))
    return flat[: h * w].reshape(h, w)


def _miss_counts(rows, cols, valid, h, w, crop):
    """Free-space visit counts over the ``crop x crop`` window anchored at
    the valid samples' low corner (clamped inside the raster), as in
    ``_miss_counts_matmul``."""
    cr, cc = min(crop, h), min(crop, w)
    big = 1 << 30
    r0 = torch.clamp(torch.where(valid, rows, big).min(), 0, max(h - cr, 0))
    c0 = torch.clamp(torch.where(valid, cols, big).min(), 0, max(w - cc, 0))
    keep = (
        valid
        & (rows - r0 >= 0) & (rows - r0 < cr)
        & (cols - c0 >= 0) & (cols - c0 < cc)
    )
    return _count_cells(rows, cols, keep, h, w)


BACKENDS = ("matmul", "scatter")


def _check_backend(backend):
    if backend not in BACKENDS:
        raise ValueError(f"unknown rasterize backend {backend!r}; one of "
                         f"{BACKENDS}")


def _delta_impl(h, w, s_xy, h_xy, mask, res, off, logodds_hit, logodds_miss,
                num_samples, crop, backend):
    """Raw (pre-clip) log-odds delta image of ONE scan."""
    dev = s_xy.device
    d = h_xy - s_xy[None, :]  # [B, 2]
    t = torch.div(
        torch.arange(num_samples, dtype=torch.float32, device=dev) + 0.5,
        f32(num_samples, dev),
    )
    pts = s_xy[None, None, :] + d[:, None, :] * t[None, :, None]  # [B, K, 2]
    rows, cols = _cell_of(pts, res, off)
    hit_r, hit_c = _cell_of(h_xy, res, off)

    same_as_prev = torch.zeros(rows.shape, dtype=torch.bool, device=dev)
    same_as_prev[:, 1:] = (rows[:, 1:] == rows[:, :-1]) & (
        cols[:, 1:] == cols[:, :-1]
    )
    is_hit_cell = (rows == hit_r[:, None]) & (cols == hit_c[:, None])
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    miss_valid = mask[:, None] & ~same_as_prev & ~is_hit_cell & inside

    if backend == "scatter":
        delta = _add_per_cell(
            torch.zeros((h, w), dtype=torch.float32, device=dev),
            rows, cols, miss_valid, logodds_miss)
    else:
        delta = _miss_counts(rows, cols, miss_valid, h, w, crop).to(
            torch.float32
        ) * float(np.float32(logodds_miss))
    hit_inside = mask & (hit_r >= 0) & (hit_r < h) & (hit_c >= 0) & (hit_c < w)
    return _add_per_cell(delta, hit_r, hit_c, hit_inside, logodds_hit)


def scan_delta(shape, sensor_xy, hits_xy, hit_mask, resolution, offset_xy,
               logodds_hit, logodds_miss,
               num_samples=DEFAULT_SAMPLES_PER_BEAM, crop=None,
               backend="matmul"):
    """Raw (pre-clip) log-odds delta image of one scan — the cacheable unit
    of the incremental latest map (``grid/builder.py``).  ``backend``:
    ``"matmul"`` or ``"scatter"`` (module docstring); ``crop`` applies to
    ``"matmul"`` only."""
    _check_backend(backend)
    h, w = shape
    return _delta_impl(
        h, w, sensor_xy, hits_xy, hit_mask, f32(resolution, sensor_xy.device),
        offset_xy, logodds_hit, logodds_miss, num_samples,
        crop if crop is not None else max(h, w), backend,
    )


def _apply_delta(lo, obs, delta):
    """One sequential Bayes step: add a scan's delta and clip (the u16
    codec's per-scan saturation)."""
    touched = delta != 0.0
    new_lo = torch.clamp(
        torch.where(obs, lo, 0.0) + delta, gv.LOGODDS_MIN, gv.LOGODDS_MAX
    )
    return torch.where(touched, new_lo, lo), obs | touched


def integrate_scans(logodds, observed, sensor_xy, hits_xy, hit_mask,
                    resolution, offset_xy, logodds_hit, logodds_miss,
                    num_samples=DEFAULT_SAMPLES_PER_BEAM, crop=None,
                    backend="matmul"):
    """Integrate S scans in sequence.  Returns updated (logodds, observed)
    and the i32 device count of valid HIT endpoints outside the raster.
    ``backend`` and ``crop`` as :func:`scan_delta`."""
    _check_backend(backend)
    if not (sensor_xy.shape[0] == hits_xy.shape[0] == hit_mask.shape[0]
            and hits_xy.shape[1] == hit_mask.shape[1]):
        raise ValueError(
            f"inconsistent scan batch: sensor {tuple(sensor_xy.shape)}, "
            f"hits {tuple(hits_xy.shape)}, mask {tuple(hit_mask.shape)}"
        )
    h, w = logodds.shape
    res = f32(resolution, logodds.device)
    crop = crop if crop is not None else max(h, w)
    for i in range(sensor_xy.shape[0]):
        delta = _delta_impl(
            h, w, sensor_xy[i], hits_xy[i], hit_mask[i], res, offset_xy,
            logodds_hit, logodds_miss, num_samples, crop, backend,
        )
        logodds, observed = _apply_delta(logodds, observed, delta)
    hit_r, hit_c = _cell_of(hits_xy, res, offset_xy)
    oob = hit_mask & ~((hit_r >= 0) & (hit_r < h) & (hit_c >= 0) & (hit_c < w))
    return logodds, observed, oob.sum().to(torch.int32)


def shift_image(delta, dr: int, dc: int):
    """``out[r, c] = delta[r - dr, c - dc]``, zero where that falls off."""
    H, W = delta.shape
    out = torch.zeros_like(delta)
    if abs(dr) < H and abs(dc) < W:
        out[max(dr, 0):H + min(dr, 0), max(dc, 0):W + min(dc, 0)] = delta[
            max(-dr, 0):H - max(dr, 0), max(-dc, 0):W - max(dc, 0)
        ]
    return out


def fold_shifted_deltas(deltas, shifts, valid, *, max_shift: int):
    """Sequential Bayes fold of per-scan delta images into a fresh raster,
    each translated by an integer cell shift first.

    ``deltas``: sequence of S ``[H, W]`` f32 device tensors; ``shifts``:
    host ``[S, 2]`` ints (dr, dc), clipped to ``max_shift``; ``valid``:
    host ``[S]`` bools.  The shifts live on the host (the builder computes
    them there), so each shift is a plain slice; an invalid entry adds
    nothing, exactly as the JAX fold's zeroed delta."""
    H, W = deltas[0].shape
    dev = deltas[0].device
    lo = torch.zeros((H, W), dtype=torch.float32, device=dev)
    obs = torch.zeros((H, W), dtype=torch.bool, device=dev)
    p = max_shift
    shifts = np.asarray(shifts)
    for i, delta in enumerate(deltas):
        if not bool(valid[i]):
            continue
        dr = int(np.clip(shifts[i, 0], -p, p))
        dc = int(np.clip(shifts[i, 1], -p, p))
        lo, obs = _apply_delta(lo, obs, shift_image(delta, dr, dc))
    return lo, obs


def prob_map(logodds, observed):
    """Probability raster with 0.0 = unknown."""
    return torch.where(observed, torch.sigmoid(logodds), 0.0)
