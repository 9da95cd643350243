"""The benchmark's traffic generator: a seeded synthetic LiDAR course.

A frozen copy of the office world, ``loop_trajectory``, ``generate`` and
``ate_rmse`` of the port's ``datasets/synthetic.py`` and of
``scripts/bench_e2e.py:build_sequence`` (the Intel-scale office course),
NumPy only, with the same random streams: a segment world with exact ray
casting, a rounded-rectangle corridor loop, and odometry whose noise is
integrated like an encoder's.  Beside it, a world of the benchmark's own:
a serpentine corridor with no loop (:func:`serpentine`).  A scan is a plain
dict with the port's ``ScanData`` field names.  A traffic file
(``traffic/<mix>.json``) gives the parameters; :func:`make` reads them.
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


def cast_rays_sparse(segments, origin_xy, headings, angles,
                     max_range: float) -> np.ndarray:
    """:func:`cast_rays` of the rays at ``headings[:, None] + angles``
    (evenly spaced), bit for bit, with each ray cast only against the
    segments whose bearing sector, as seen from its origin, it lies in or
    lies within a beam's spacing of: any other ray misses.  Each ray and
    segment pair kept goes through :func:`cast_rays`'s arithmetic.
    ``origin_xy`` [P, 2], ``headings`` [P]; the result is [P, R]."""
    n_p, n_r = len(origin_xy), len(angles)
    if len(segments) == 0:
        return np.full((n_p, n_r), float(max_range))
    ox, oy = origin_xy[:, 0:1], origin_xy[:, 1:2]
    dirs = headings[:, None] + angles
    dx, dy = np.cos(dirs), np.sin(dirs)
    x0, y0, x1, y1 = (segments[:, i] for i in range(4))
    ex, ey = x1 - x0, y1 - y0
    num_t = (x0 - ox) * ey - (y0 - oy) * ex                      # [P, S]
    # Each endpoint's bearing from the first beam, in [0, 2 pi); the
    # short sector between them, widened by one beam each way.
    two_pi = 2 * np.pi
    base = headings[:, None] + angles[0]
    b0 = np.mod(np.arctan2(y0 - oy, x0 - ox) - base, two_pi)
    b1 = np.mod(np.arctan2(y1 - oy, x1 - ox) - base, two_pi)
    d = np.mod(b1 - b0, two_pi)
    start = np.where(d <= np.pi, b0, b1)
    span = np.where(d <= np.pi, d, two_pi - d)
    step = (angles[-1] - angles[0]) / (n_r - 1)
    pairs, beams = [], []
    for shift in (0.0, two_pi):
        k0 = np.clip(np.ceil((start - shift) / step - 1.0), 0, n_r)
        k1 = np.clip(np.floor((start + span - shift) / step + 1.0), -1,
                     n_r - 1)
        cnt = np.maximum(k1 - k0 + 1, 0).astype(np.int64).ravel()
        idx = np.repeat(np.arange(cnt.size), cnt)
        first = np.cumsum(cnt) - cnt
        pairs.append(idx)
        beams.append(k0.ravel().astype(np.int64)[idx]
                     + np.arange(idx.size) - first[idx])
    pair, k = np.concatenate(pairs), np.concatenate(beams)
    p, s = np.divmod(pair, len(segments))
    dxk, dyk = dx[p, k], dy[p, k]
    denom = dxk * ey[s] - dyk * ex[s]
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t = num_t[p, s] / denom
    u = ((x0[s] - ox[p, 0]) * dyk - (y0[s] - oy[p, 0]) * dxk) / denom
    hit = (t > 1e-9) & (u >= 0.0) & (u <= 1.0)
    out = np.full(n_p * n_r, np.inf)
    np.minimum.at(out, p[hit] * n_r + k[hit], t[hit])
    return np.minimum(out.reshape(n_p, n_r), max_range)


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
             chunk=256, visible=None):
    """(scans, ground truth [n, 3]): a scan at every pose, and odometry
    whose per-step noise scales with the step.  The rays of ``chunk``
    poses are cast at once and the normal deviates drawn in one call, in
    the per-scan order (181 range deviates, then 3 odometry ones), so the
    values equal those of a scan-by-scan loop.  Where ``visible(i0, i1)``
    is given, it names the segments that the rays of poses ``i0 .. i1 - 1``
    can hit, and only those are cast against (:func:`cast_rays_sparse`):
    the ranges are the same as against every segment."""
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
        if visible is None:
            ranges[i:i + chunk] = cast_rays(segments, s[:, :2],
                                            s[:, 2:3] + angles, max_range)
        else:
            ranges[i:i + chunk] = cast_rays_sparse(
                segments[visible(i, i + len(s))], s[:, :2], s[:, 2],
                angles, max_range)
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


def serpentine(n_legs: int, seed: int = 0, width: float = 3.0,
               leg_length: float = 24.0, leg_spacing: float = 8.0,
               feature_spacing=(1.0, 3.0)):
    """(segments [S, 4], region [S]) of a serpentine corridor ``width``
    wide: ``n_legs`` straight legs along x from 0 to ``leg_length``, leg k
    on the centreline y = k * ``leg_spacing``; leg k and k + 1 joined by a
    rounded U-turn of centreline radius ``leg_spacing`` / 2 at the end of
    leg k (x = ``leg_length`` for even k, 0 for odd); a wall across the
    start of the first leg and the end of the last.  Both walls of every
    leg carry, from the ``seed``, a wall stub or a pillar every
    ``feature_spacing`` metres (drawn in that range), so that a match along
    the corridor is not degenerate.  A segment's region is 2k on leg k and
    2k + 1 on the U-turn after it."""
    rng = np.random.default_rng(seed)
    h, r = width / 2, leg_spacing / 2
    lo, hi = feature_spacing
    segs, region = [], []

    def polyline(points, reg):
        for a, b in zip(points[:-1], points[1:]):
            segs.append((*a, *b))
            region.append(reg)

    for k in range(n_legs):
        y = k * leg_spacing
        for side in (-1.0, 1.0):
            wall = y + side * h
            polyline([(0.0, wall), (leg_length, wall)], 2 * k)
            x = 0.5 + rng.uniform(0.0, hi)
            while x < leg_length - 1.0:
                if rng.uniform() < 0.5:     # a stub 0.2-0.5 m deep
                    d = rng.uniform(0.2, 0.5)
                    polyline([(x, wall), (x, wall - side * d)], 2 * k)
                else:                       # a pillar set into the wall
                    w, d = rng.uniform(0.2, 0.4), rng.uniform(0.15, 0.35)
                    polyline([(x, wall), (x, wall - side * d),
                              (x + w, wall - side * d), (x + w, wall)], 2 * k)
                x += rng.uniform(lo, hi)
        if k == 0:
            polyline([(0.0, -h), (0.0, h)], 0)
        x_end = leg_length if k % 2 == 0 else 0.0
        if k == n_legs - 1:
            polyline([(x_end, y - h), (x_end, y + h)], 2 * k)
            break
        bulge = 1.0 if k % 2 == 0 else -1.0
        for rho, n_seg in ((r - h, 8), (r + h, 16)):
            phi = np.linspace(0.0, np.pi, n_seg + 1)
            polyline(list(zip(x_end + bulge * rho * np.sin(phi),
                              y + r - rho * np.cos(phi))), 2 * k + 1)
    return np.asarray(segs, np.float64), np.asarray(region, np.int64)


def serpentine_path(length: float, step: float, leg_length: float = 24.0,
                    leg_spacing: float = 8.0, start: float = 1.0):
    """Poses [n, 3] every ``step`` metres along :func:`serpentine`'s
    centreline for ``length`` metres, from ``start`` metres into the first
    leg, and the region [n] of each pose."""
    r = leg_spacing / 2
    s = np.arange(int(length / step) + 1) * step + start
    period = leg_length + np.pi * r
    k = (s // period).astype(np.int64)
    q = s - k * period
    on_leg = q < leg_length
    fwd = k % 2 == 0
    phi = np.maximum(q - leg_length, 0.0) / r
    y = k * leg_spacing
    x = np.where(on_leg, np.where(fwd, q, leg_length - q),
                 np.where(fwd, leg_length + r * np.sin(phi),
                          -r * np.sin(phi)))
    y = np.where(on_leg, y, y + r - r * np.cos(phi))
    heading = np.where(on_leg, np.where(fwd, 0.0, np.pi),
                       np.where(fwd, phi, np.pi - phi))
    return np.stack([x, y, heading], axis=-1), 2 * k + (~on_leg)


def serpentine_visible(segments, seg_region, pose_region, pose_xy,
                       max_range: float):
    """``visible(i0, i1)`` for :func:`generate`: the segments within
    ``max_range`` of poses i0 .. i1 - 1 that their rays can reach.  A ray
    is straight, so its x is monotone, and each leg's walls run its whole
    length: from a leg it meets only that leg and the U-turns at its ends
    (regions within 1), from a U-turn only the two legs it joins and their
    far U-turns (within 2); a wall or U-turn closes every other way."""
    lo_xy = np.minimum(segments[:, :2], segments[:, 2:])
    hi_xy = np.maximum(segments[:, :2], segments[:, 2:])

    def visible(i0, i1):
        reg = pose_region[i0:i1]
        reach = 1 + reg % 2
        xy = pose_xy[i0:i1]
        keep = ((seg_region >= (reg - reach).min())
                & (seg_region <= (reg + reach).max())
                & np.all(lo_xy <= xy.max(0) + max_range, axis=1)
                & np.all(hi_xy >= xy.min(0) - max_range, axis=1))
        return np.nonzero(keep)[0]
    return visible


def make(params: dict, seed: int):
    """The course a traffic file describes: (scans, ground truth, index of
    the first scan of the measured window).  One building, as a log is:
    the world comes from the file's ``world_seed``; the run's ``seed``
    draws the range and odometry noise.  Without a ``world`` key, laps of
    the office after ``warmup_laps`` of them; with ``"world":
    "serpentine"``, one pass down a serpentine corridor, the window after
    ``warmup_keyframes`` keyframes' travel."""
    world = params.get("world")
    if world is None:
        scans, gt, laps = build_sequence(
            params["course_keyframes"], seed=seed, step=params["step"],
            size=params["size"], keyframe_travel=params["keyframe_travel"],
            n_beams=params["n_beams"], max_range=params["max_range"],
            range_noise=params["range_noise"], odom_noise=params["odom_noise"],
            world_seed=params["world_seed"])
        per_lap = len(scans) / laps
        return scans, gt, int(round(params["warmup_laps"] * per_lap))
    if world != "serpentine":
        raise ValueError(f"unknown world {world!r}")
    step, travel = params["step"], params["keyframe_travel"]
    traj, region = serpentine_path(
        params["course_keyframes"] * travel * 1.06, step,
        params["leg_length"], params["leg_spacing"])
    segs, seg_region = serpentine(
        int(region[-1]) // 2 + 2, params["world_seed"],
        params["corridor_width"], params["leg_length"],
        params["leg_spacing"], tuple(params["feature_spacing"]))
    # Chunks of 64 poses (5 m) keep the segments they reach to few regions.
    scans, gt = generate(
        segs, traj, n_beams=params["n_beams"], max_range=params["max_range"],
        range_noise=params["range_noise"],
        odom_noise=tuple(params["odom_noise"]), seed=seed, chunk=64,
        visible=serpentine_visible(segs, seg_region, region, traj[:, :2],
                                   params["max_range"]))
    warm = int(round(params["warmup_keyframes"] * travel * 1.06 / step))
    return scans, gt, warm
