"""Refinement inputs for the Gauss-Newton tests, from the benchmark's
revisit course (``slam_bench/course.py``, the office of seed 0, noise of
seed 0): a map of ten keyframe scans integrated at their true poses, and a
scan to refine against it from a start near its true pose.

- ``frontend``: the next keyframe's scan against the latest ten (the
  fold's map), 512 beams of which the course's 181 are valid;
- ``loop``: a scan of the second lap against the first lap's map, from a
  start a few cm and a degree off (what a loop search hands the final
  matcher).

Imports no JAX (the card's tests use it too).
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch

from my_lidar_graph_slam_v2_tpu_torch.core import pose as P
from my_lidar_graph_slam_v2_tpu_torch.ops import quant, rasterize
from slam_bench import course

ROOT = Path(__file__).resolve().parent.parent
RES = 0.05
SIZE = 512
CAPACITY = 512
# Keyframes every 6 course steps (0.5 m of travel at 0.08 m a step).
KEYFRAME_STEP = 6
MAP_SCANS = 10
LOGODDS_HIT = float(np.log(0.62 / 0.38))
LOGODDS_MISS = float(np.log(0.46 / 0.54))


@functools.lru_cache(maxsize=None)
def _course():
    params = json.loads((ROOT / "slam_bench/traffic/revisit.json").read_text())
    params["course_keyframes"] = 140
    scans, gt, _ = course.make(params, 0)
    return scans, np.asarray(gt), course.office(seed=params["world_seed"],
                                                size=params["size"])


def _beams(scan, capacity=CAPACITY):
    """The scan's beams padded to ``capacity``: (ranges, angles, mask)."""
    n = len(scan["ranges"])
    r = np.zeros(capacity, np.float32)
    a = np.zeros(capacity, np.float32)
    m = np.zeros(capacity, bool)
    r[:n], a[:n] = scan["ranges"], scan["angles"]
    m[:n] = (r[:n] > 0.01) & (r[:n] < 20.0)
    return r, a, m


def offset_of(size: int):
    """The map-local origin that centres a ``size``-cell raster on the
    office."""
    return np.float32([-size * RES / 2] * 2)


@functools.lru_cache(maxsize=None)
def _map(first: int, size: int):
    """Log-odds and observed mask of the ten keyframe scans from course
    step ``first``, integrated at their true poses into a ``size`` x
    ``size`` raster."""
    scans, gt, _ = _course()
    idx = range(first, first + MAP_SCANS * KEYFRAME_STEP, KEYFRAME_STEP)
    sensor_xy, hits_xy, masks = [], [], []
    for i in idx:
        r, a, m = _beams(scans[i])
        pose = gt[i]
        sensor_xy.append(pose[:2])
        hits_xy.append(np.stack([pose[0] + r * np.cos(pose[2] + a),
                                 pose[1] + r * np.sin(pose[2] + a)], -1))
        masks.append(m)
    lo = torch.zeros((size, size), dtype=torch.float32)
    obs = torch.zeros((size, size), dtype=torch.bool)
    lo, obs, _ = rasterize.integrate_scans(
        lo, obs, torch.as_tensor(np.float32(sensor_xy)),
        torch.as_tensor(np.float32(hits_xy)), torch.as_tensor(np.stack(masks)),
        RES, torch.as_tensor(offset_of(size)), LOGODDS_HIT, LOGODDS_MISS,
        num_samples=256,
    )
    return lo, obs


def raster(first: int, f32: bool = False, size: int = SIZE):
    """(prob, observed): the map as the matchers take it, u8 or f32."""
    lo, obs = _map(first, size)
    prob = (rasterize.prob_map(lo, obs) if f32
            else quant.quantize_prob(lo, obs))
    return prob, obs


def cast(i: int, n: int, noise_seed: int = 0):
    """``n`` beams over the course scan's field of view, cast from the
    true pose of course step ``i`` with 1 cm of range noise: (ranges,
    angles, mask), every beam valid below 20 m."""
    _, gt, world = _course()
    rng = np.random.default_rng(noise_seed)
    a = np.linspace(-np.pi / 2, np.pi / 2, n)
    r = course.cast_rays(world, gt[i][:2], gt[i][2] + a, 30.0)
    r = r + rng.normal(0.0, 0.01, n)
    return np.float32(r), np.float32(a), (r > 0.01) & (r < 20.0)


def case(name: str, start_seed: int = None, f32: bool = False,
         beams: int = None, size: int = SIZE):
    """Inputs of ``gauss_newton.refine`` (CPU tensors) for the course case
    ``name`` (``frontend`` or ``loop``): ``(prob, observed, ranges,
    angles, mask, start pose, resolution, offset)``.  ``start_seed``
    draws a random start (up to 6 cm and 0.03 rad off the true pose);
    ``beams`` replaces the scan by that many beams cast at the same
    pose; ``size`` is the raster's side in cells (the system's maps are
    1024)."""
    scans, gt, _ = _course()
    if name == "frontend":
        first = 0
        query = MAP_SCANS * KEYFRAME_STEP
        offset = np.float32([0.02, -0.015, 0.01])
    elif name == "loop":
        first = 0
        d = np.hypot(gt[300:, 0] - gt[30, 0], gt[300:, 1] - gt[30, 1])
        query = 300 + int(np.argmin(d))
        offset = np.float32([0.04, 0.03, -0.02])
    else:
        raise ValueError(name)
    if start_seed is not None:
        rng = np.random.default_rng(start_seed)
        offset = np.float32(rng.uniform(-1, 1, 3) * [0.06, 0.06, 0.03])
    prob, obs = raster(first, f32, size)
    if beams is None:
        r, a, m = _beams(scans[query])
    else:
        r, a, m = cast(query, beams)
    start = P.compound(gt[query], offset)
    start[2] = np.arctan2(np.sin(start[2]), np.cos(start[2]))
    start = np.float32(start)
    return (prob, obs, torch.as_tensor(r), torch.as_tensor(a),
            torch.as_tensor(m), torch.as_tensor(start), RES,
            torch.as_tensor(offset_of(size)))


def assert_same_bits(got, ref):
    """Each tensor of ``got`` has the dtype, shape and bits of ``ref``'s
    (``torch.equal``), NaN where it is NaN; ``got`` may be on any device."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.cpu()
        assert g.dtype == r.dtype and g.shape == r.shape, (g, r)
        nan = torch.isnan(r)
        assert torch.equal(torch.isnan(g), nan), (g, r)
        assert torch.equal(g[~nan], r[~nan]), (g, r)
