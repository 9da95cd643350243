"""Copy of ``my_lidar_graph_slam_v2_tpu/datasets/synthetic.py`` with its
``core.pose`` import pointed at the port's (NumPy) pose algebra; the
logic is unchanged.

Synthetic 2D LiDAR world generator.

The reference is validated on Radish benchmark logs (Intel Research Lab,
FR079, MIT-CSAIL; ``experiments_old.md:186-197``) which do not ship with
either repo.  This module provides an equivalent validation vehicle: a
segment-based 2D world with exact ray casting, trajectory synthesis, and
noisy odometry, producing the same ``ScanData`` stream a Carmen log reader
would — with ground truth attached so tests can measure ATE directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..core import pose as P
from ..sensor.data import ScanData


@dataclass
class World:
    """Collection of wall segments [(x0, y0, x1, y1), ...]."""

    segments: np.ndarray  # [S, 4]

    @staticmethod
    def office(seed: int = 0, size: float = 18.0, n_rooms: int = 5) -> "World":
        """An office-like loop: an outer rectangle, inner courtyard block
        (so a loop trajectory exists), and random wall stubs + pillars for
        texture (plain rectangles are rotationally ambiguous)."""
        rng = np.random.default_rng(seed)
        segs: List[Tuple[float, float, float, float]] = []
        h = size / 2

        def rect(x0, y0, x1, y1):
            segs.extend(
                [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1), (x0, y1, x0, y0)]
            )

        rect(-h, -h, h, h)  # outer walls
        rect(-h * 0.45, -h * 0.45, h * 0.45, h * 0.45)  # inner block
        # The loop trajectory rides a ring with max(|x|, |y|) in roughly
        # [0.55h, 0.75h]; obstacles must stay clear of that band.
        # Wall stubs off the outer wall (short, so they never reach the path)
        for _ in range(n_rooms * 2):
            side = rng.integers(0, 4)
            t = rng.uniform(-h * 0.9, h * 0.9)
            depth = rng.uniform(0.3, 0.17 * h)
            if side == 0:
                segs.append((t, -h, t, -h + depth))
            elif side == 1:
                segs.append((t, h, t, h - depth))
            elif side == 2:
                segs.append((-h, t, -h + depth, t))
            else:
                segs.append((h, t, h - depth, t))
        # Pillars hugging the outer wall
        for _ in range(n_rooms * 3):
            cx = rng.uniform(-h * 0.93, h * 0.93)
            cy = rng.uniform(-h * 0.93, h * 0.93)
            r = rng.uniform(0.1, 0.25)
            if max(abs(cx), abs(cy)) < h * 0.86:
                continue  # keep the corridor band clear
            rect(cx - r, cy - r, cx + r, cy + r)
        return World(np.asarray(segs, np.float64))

    def cast_rays(self, origin_xy, dirs, max_range: float) -> np.ndarray:
        """Exact ray-segment intersection: returns ranges [len(dirs)],
        clipped to max_range where nothing is hit."""
        ox, oy = origin_xy
        dx = np.cos(dirs)[:, None]  # [R, 1]
        dy = np.sin(dirs)[:, None]
        x0, y0, x1, y1 = (self.segments[:, i][None, :] for i in range(4))  # [1, S]
        ex, ey = x1 - x0, y1 - y0
        denom = dx * ey - dy * ex
        denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        t = ((x0 - ox) * ey - (y0 - oy) * ex) / denom  # along ray
        u = ((x0 - ox) * dy - (y0 - oy) * dx) / denom  # along segment
        hit = (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
        t = np.where(hit, t, np.inf)
        ranges = t.min(axis=1)
        return np.minimum(ranges, max_range)


@dataclass
class SyntheticSequence:
    scans: List[ScanData]
    ground_truth: np.ndarray  # [T, 3] true poses at scan times
    world: World


def loop_trajectory(
    size: float = 18.0, laps: float = 1.2, step: float = 0.08, seed: int = 0
) -> np.ndarray:
    """A rounded-rectangle corridor loop between the outer wall and inner
    block, yielding loop closures after one lap."""
    h = size / 2
    r = h * 0.72  # corridor center radius
    per_lap = int(2 * np.pi * r / step)
    n = int(per_lap * laps)
    ang = np.linspace(0, 2 * np.pi * laps, n)
    # Superellipse-ish path
    cx = r * np.sign(np.cos(ang)) * np.abs(np.cos(ang)) ** 0.7
    cy = r * np.sign(np.sin(ang)) * np.abs(np.sin(ang)) ** 0.7
    heading = np.arctan2(np.gradient(cy), np.gradient(cx))
    heading = np.unwrap(heading)
    return np.stack([cx, cy, heading], axis=-1)


def generate(
    world: World,
    trajectory: np.ndarray,
    n_beams: int = 181,
    fov: float = np.pi,
    max_range: float = 30.0,
    range_noise: float = 0.01,
    odom_noise: Tuple[float, float] = (0.01, 0.004),
    sensor_offset: np.ndarray | None = None,
    dt: float = 0.1,
    seed: int = 0,
) -> SyntheticSequence:
    """Generate scans + noisy odometry along a trajectory.

    Odometry noise: each relative motion gets Gaussian noise proportional
    to the step (translational fraction, angular rad per step), integrated
    so odometry drifts like a real encoder."""
    rng = np.random.default_rng(seed)
    sensor_offset = (
        np.zeros(3) if sensor_offset is None else np.asarray(sensor_offset)
    )
    angles = np.linspace(-fov / 2, fov / 2, n_beams)
    scans: List[ScanData] = []
    odom = trajectory[0].copy()
    gt = []
    for i, pose in enumerate(trajectory):
        sensor_pose = P.compound(pose, sensor_offset)
        dirs = sensor_pose[2] + angles
        ranges = world.cast_rays(sensor_pose[:2], dirs, max_range)
        ranges = ranges + rng.normal(0, range_noise, n_beams)
        if i > 0:
            rel = P.inverse_compound(trajectory[i - 1], pose)
            d = float(P.distance(rel))
            noise = np.array(
                [
                    rng.normal(0, odom_noise[0] * (d + 0.01)),
                    rng.normal(0, odom_noise[0] * (d + 0.01)),
                    rng.normal(0, odom_noise[1]),
                ]
            )
            odom = P.compound(odom, rel + noise)
        scans.append(
            ScanData(
                sensor_id="SYNTH",
                time_stamp=i * dt,
                odom_pose=odom.copy(),
                velocity=np.zeros(3),
                relative_sensor_pose=sensor_offset.copy(),
                min_range=0.0,
                max_range=max_range,
                min_angle=float(angles[0]),
                max_angle=float(angles[-1]),
                angles=angles.copy(),
                ranges=ranges,
            )
        )
        gt.append(pose.copy())
    return SyntheticSequence(scans, np.asarray(gt), world)


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray) -> float:
    """Absolute trajectory error (RMSE of xy) after SE(2) alignment of the
    estimated trajectory to ground truth (Umeyama, rotation+translation
    only — scale is fixed at 1 for SLAM)."""
    est = np.asarray(estimated)[:, :2]
    gt = np.asarray(ground_truth)[: len(est), :2]
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    cov = e.T @ g
    u, _, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    R = vt.T @ np.diag([1, d]) @ u.T
    aligned = (R @ e.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
