"""The benchmark's traffic generator: a seeded synthetic LiDAR course.

A frozen copy of the office world, ``loop_trajectory``, ``generate`` and
``ate_rmse`` of the port's ``datasets/synthetic.py`` and of
``scripts/bench_e2e.py:build_sequence`` (the Intel-scale office course),
NumPy only, with the same random streams: a segment world with exact ray
casting, a rounded-rectangle corridor loop, and odometry whose noise is
integrated like an encoder's.  A scan is a plain dict with the port's
``ScanData`` field names.  A traffic file (``traffic/<mix>.json``) gives
the parameters; :func:`make` reads them.
"""
from __future__ import annotations

import numpy as np

from .reference.pose import compound, distance, inverse_compound


def office(seed: int = 0, size: float = 18.0, n_rooms: int = 5) -> np.ndarray:
    """Wall segments [S, 4] of an office loop: outer walls, an inner
    block, wall stubs and pillars off the outer wall."""
    rng = np.random.default_rng(seed)
    segs = []
    h = size / 2

    def rect(x0, y0, x1, y1):
        segs.extend([(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1),
                     (x0, y1, x0, y0)])

    rect(-h, -h, h, h)
    rect(-h * 0.45, -h * 0.45, h * 0.45, h * 0.45)
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
    for _ in range(n_rooms * 3):
        cx = rng.uniform(-h * 0.93, h * 0.93)
        cy = rng.uniform(-h * 0.93, h * 0.93)
        r = rng.uniform(0.1, 0.25)
        if max(abs(cx), abs(cy)) < h * 0.86:
            continue
        rect(cx - r, cy - r, cx + r, cy + r)
    return np.asarray(segs, np.float64)


def cast_rays(segments, origin_xy, dirs, max_range: float) -> np.ndarray:
    """Exact ray-segment intersection; ``max_range`` where nothing is
    hit.  ``origin_xy`` [..., 2] and ``dirs`` [..., R] broadcast; the
    result is [..., R]."""
    origin_xy = np.asarray(origin_xy)
    ox, oy = origin_xy[..., 0:1, None], origin_xy[..., 1:2, None]
    dx = np.cos(dirs)[..., None]
    dy = np.sin(dirs)[..., None]
    x0, y0, x1, y1 = (segments[:, i] for i in range(4))
    ex, ey = x1 - x0, y1 - y0
    denom = dx * ey - dy * ex
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = ((x0 - ox) * ey - (y0 - oy) * ex) / denom
    u = ((x0 - ox) * dy - (y0 - oy) * dx) / denom
    hit = (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
    t = np.where(hit, t, np.inf)
    return np.minimum(t.min(axis=-1), max_range)


def loop_trajectory(size: float = 18.0, laps: float = 1.2,
                    step: float = 0.08) -> np.ndarray:
    """Poses [n, 3] along a rounded-rectangle corridor loop between the
    outer wall and the inner block."""
    h = size / 2
    r = h * 0.72
    per_lap = int(2 * np.pi * r / step)
    n = int(per_lap * laps)
    ang = np.linspace(0, 2 * np.pi * laps, n)
    cx = r * np.sign(np.cos(ang)) * np.abs(np.cos(ang)) ** 0.7
    cy = r * np.sign(np.sin(ang)) * np.abs(np.sin(ang)) ** 0.7
    heading = np.unwrap(np.arctan2(np.gradient(cy), np.gradient(cx)))
    return np.stack([cx, cy, heading], axis=-1)


def generate(segments, trajectory, n_beams=181, fov=np.pi, max_range=30.0,
             range_noise=0.01, odom_noise=(0.01, 0.004), dt=0.1, seed=0,
             chunk=256):
    """(scans, ground truth [n, 3]): a scan at every pose, and odometry
    whose per-step noise scales with the step.  The rays of ``chunk``
    poses are cast at once and the normal deviates drawn in one call, in
    the per-scan order (181 range deviates, then 3 odometry ones), so the
    values equal those of a scan-by-scan loop."""
    rng = np.random.default_rng(seed)
    offset = np.zeros(3)
    angles = np.linspace(-fov / 2, fov / 2, n_beams)
    n = len(trajectory)
    z = rng.standard_normal(n_beams + (n_beams + 3) * (n - 1))
    z_ranges = np.concatenate([z[:n_beams], z[n_beams:].reshape(
        n - 1, n_beams + 3)[:, :n_beams].reshape(-1)]).reshape(n, n_beams)
    z_odom = z[n_beams:].reshape(n - 1, n_beams + 3)[:, n_beams:]
    sensor = compound(trajectory, offset)
    ranges = np.empty((n, n_beams))
    for i in range(0, n, chunk):
        s = sensor[i:i + chunk]
        ranges[i:i + chunk] = cast_rays(segments, s[:, :2],
                                        s[:, 2:3] + angles, max_range)
    ranges = ranges + range_noise * z_ranges
    scans = []
    odom = trajectory[0].copy()
    for i in range(n):
        if i > 0:
            rel = inverse_compound(trajectory[i - 1], trajectory[i])
            d = float(distance(rel))
            s = odom_noise[0] * (d + 0.01)
            noise = np.array([s * z_odom[i - 1, 0], s * z_odom[i - 1, 1],
                              odom_noise[1] * z_odom[i - 1, 2]])
            odom = compound(odom, rel + noise)
        scans.append(dict(
            sensor_id="SYNTH", time_stamp=i * dt, odom_pose=odom.copy(),
            velocity=np.zeros(3), relative_sensor_pose=offset.copy(),
            min_range=0.0, max_range=max_range, min_angle=float(angles[0]),
            max_angle=float(angles[-1]), angles=angles.copy(),
            ranges=ranges[i].copy()))
    return scans, np.asarray(trajectory)


def ate_rmse(estimated, ground_truth) -> float:
    """RMSE of xy after an SE(2) alignment (Umeyama, no scale)."""
    est = np.asarray(estimated)[:, :2]
    gt = np.asarray(ground_truth)[: len(est), :2]
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    u, _, vt = np.linalg.svd(e.T @ g)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1, d]) @ u.T
    aligned = (rot @ e.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def lap_length(size: float, step: float) -> float:
    one = loop_trajectory(size=size, laps=1.0, step=step)
    return float(np.sum(np.hypot(np.diff(one[:, 0]), np.diff(one[:, 1]))))


def build_sequence(target_keyframes: int, seed: int = 0, step: float = 0.08,
                   size: float = 18.0, keyframe_travel: float = 0.5,
                   n_beams: int = 181, max_range: float = 30.0,
                   range_noise: float = 0.01, odom_noise=(0.01, 0.004),
                   world_seed=None):
    """Laps of the office course long enough for ``target_keyframes`` at
    the frontend's travel gate; the office from ``world_seed`` (``seed``
    where None), the noise from ``seed``.  With ``world_seed`` None,
    ``bench_e2e``'s sequence, bit for bit.  Returns (scans, ground truth,
    laps)."""
    laps = target_keyframes * keyframe_travel * 1.06 / lap_length(size, step)
    traj = loop_trajectory(size=size, laps=laps, step=step)
    world = office(seed=seed if world_seed is None else world_seed, size=size)
    scans, gt = generate(world, traj, n_beams=n_beams,
                         max_range=max_range, range_noise=range_noise,
                         odom_noise=tuple(odom_noise), seed=seed)
    return scans, gt, laps


def make(params: dict, seed: int):
    """The course a traffic file describes: (scans, ground truth, index of
    the first scan of the measured window).  One building, as a log is:
    the office comes from the file's ``world_seed``; the run's ``seed``
    draws the range and odometry noise."""
    scans, gt, laps = build_sequence(
        params["course_keyframes"], seed=seed, step=params["step"],
        size=params["size"], keyframe_travel=params["keyframe_travel"],
        n_beams=params["n_beams"], max_range=params["max_range"],
        range_noise=params["range_noise"], odom_noise=params["odom_noise"],
        world_seed=params["world_seed"])
    per_lap = len(scans) / laps
    return scans, gt, int(round(params["warmup_laps"] * per_lap))
