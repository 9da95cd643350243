"""Sliding-window max pooling for the coarse-map precompute.

Port of ``my_lidar_graph_slam_v2_tpu/ops/pool.py``
(reference ``grid_map_builder.cpp:917-1065``): each output cell holds the
max over the ``win x win`` window *starting* at that cell (extending
toward higher indices), with shrinking windows at the high edge.  Per axis
the window max is built by doubling shifted maxima, ``O(log win)``
elementwise ops; :func:`pyramid` builds branch-and-bound's levels the same
way.  Max is exact, so the results equal the JAX ops bit for bit.
"""
from __future__ import annotations

import torch


def _pad_value(dtype):
    if dtype == torch.bool:
        return False
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _shift(arr: torch.Tensor, axis: int, s: int, fill) -> torch.Tensor:
    """out[i] = arr[i + s] along ``axis``, ``fill`` beyond the high edge."""
    if s == 0:
        return arr
    n = arr.shape[axis]
    out = torch.full_like(arr, fill)
    out.narrow(axis, 0, max(n - s, 0)).copy_(
        arr.narrow(axis, min(s, n), max(n - s, 0))
    )
    return out


def _axis_window_max(arr: torch.Tensor, axis: int, win: int) -> torch.Tensor:
    """out[i] = max(arr[i:i+win]) along ``axis`` (high edge shrinks)."""
    if win == 1:
        return arr
    fill = _pad_value(arr.dtype)
    g = arr
    width = 1
    while width * 2 <= win:
        g = torch.maximum(g, _shift(g, axis, width, fill))
        width *= 2
    if width == win:
        return g
    return torch.maximum(g, _shift(g, axis, win - width, fill))


def sliding_window_max2d(arr: torch.Tensor, win: int) -> torch.Tensor:
    """out[..., i, j] = max(arr[..., i:i+win, j:j+win]) over the last two
    axes, dtype-min padding beyond the high edge.  Bool maps go through
    u8."""
    if win == 1:
        return arr
    if arr.dtype == torch.bool:
        return sliding_window_max2d(arr.to(torch.uint8), win).to(torch.bool)
    out = _axis_window_max(arr, arr.ndim - 2, win)
    return _axis_window_max(out, arr.ndim - 1, win)


def pyramid(arr: torch.Tensor, max_height: int):
    """Coarse-map pyramid for branch-and-bound: heights 0..max_height with
    window 2^h, all at the original resolution and geometry
    (``PrecomputeGridMaps``, ``grid_map_builder.cpp:986-1012``).  Level h
    is the max of 4 shifted copies of level h-1, dtype-min beyond the high
    edge; bool maps go through u8."""
    if arr.dtype == torch.bool:
        return [m.to(torch.bool)
                for m in pyramid(arr.to(torch.uint8), max_height)]
    fill = _pad_value(arr.dtype)
    maps = [arr]
    for h in range(1, max_height + 1):
        prev = maps[-1]
        s = 1 << (h - 1)
        row = torch.maximum(prev, _shift(prev, prev.ndim - 2, s, fill))
        maps.append(torch.maximum(row, _shift(row, prev.ndim - 1, s, fill)))
    return maps
