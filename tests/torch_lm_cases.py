"""Pose graphs for the LM's tests on the CPU and the card (NumPy and
PyTorch only, no JAX), and the eager LM on their own or padded shapes."""
import numpy as np
import torch

from my_lidar_graph_slam_v2_tpu_torch.graph.optimizer import (
    EdgeShard,
    clip_info,
    optimize_core,
    pad_graph,
)


def loop_graph(rng):
    """An over-constrained map/scan graph: noisy intra edges, an inter edge
    per map, loop edges from map 0 to the last scans."""
    M, per_map = 4, 6
    N = M * per_map
    mi = list(np.repeat(np.arange(M), per_map)) + list(range(M - 1)) + [0] * 4
    si = list(range(N)) + [per_map * (m + 1) for m in range(M - 1)] + \
        list(range(N - 4, N))
    il = [0] * (N + M - 1) + [1] * 4
    E = len(mi)
    edges = (np.array(mi, np.int32), np.array(si, np.int32),
             np.array(il, np.int32), rng.normal(0, 0.3, (E, 3)),
             np.tile(np.eye(3) * 100.0, (E, 1, 1)))
    return rng.normal(0, 1, (M, 3)), rng.normal(0, 1, (N, 3)), edges


def _between(a, b):
    """Poses ``b`` in the frames of poses ``a``."""
    d = b - a
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                     np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))], -1)


def walk_graph(seed, n_maps, scans_per_map, n_loops, pins=True):
    """A SLAM-like graph: scans along a random walk, a map node at every
    ``scans_per_map``-th scan, each scan tied to its map and the first scan
    of a map to the map before, ``n_loops`` loop edges from random maps
    to later scans, noisy relative poses and initial poses, random
    information and, with ``pins``, every tenth edge's pinned at 1e9 (the
    reference's pins, clipped to 1e5: an ill-conditioned system, whose
    solve moves the last bits of f64 sums into the f32 poses)."""
    rng = np.random.default_rng(seed)
    N = n_maps * scans_per_map
    heading = np.cumsum(rng.normal(0, 0.15, N))
    xy = np.cumsum(np.stack([np.cos(heading), np.sin(heading)], -1) * 0.5, 0)
    scans = np.column_stack([xy, heading])
    maps = scans[::scans_per_map] + rng.normal(0, 0.05, (n_maps, 3))
    mi = [j // scans_per_map for j in range(N)] + list(range(n_maps - 1))
    si = list(range(N)) + [scans_per_map * (m + 1) for m in range(n_maps - 1)]
    il = [0] * len(mi)
    for _ in range(n_loops):
        m = int(rng.integers(0, n_maps - 2))
        mi.append(m)
        si.append(int(rng.integers(scans_per_map * (m + 2), N)))
        il.append(1)
    mi, si, il = (np.array(a, np.int32) for a in (mi, si, il))
    E = len(mi)
    rel = _between(maps[mi], scans[si]) + rng.normal(0, 0.02, (E, 3))
    a = rng.normal(0, 0.3, (E, 3, 3)) + np.eye(3)
    info = a @ a.transpose(0, 2, 1) * 50.0
    if pins:
        info[::10] = np.eye(3) * 1e9
    return (maps + rng.normal(0, 0.1, maps.shape),
            scans + rng.normal(0, 0.1, scans.shape), (mi, si, il, rel, info))


def core_lm(cfg, map_poses, scan_poses, edges, lam, device, pad=False):
    """``optimize_core`` run eagerly from lambda ``lam``, the information
    clipped as the wrapper clips it, on the graph's own shapes or
    (``pad``) on the wrapper's padded ones: (map poses, scan poses) as f32
    arrays of the graph's rows and (error, lambda, iterations, initial
    error) as floats."""
    M, N = len(map_poses), len(scan_poses)
    edges = edges[:4] + (clip_info(edges[4], cfg.info_clip),)
    real = None
    if pad:
        map_poses, scan_poses, edges, real = pad_graph(map_poses, scan_poses,
                                                       edges)
    shard = EdgeShard.upload(device, *edges, real)
    f32 = dict(dtype=torch.float32, device=device)
    out = optimize_core(
        cfg, len(map_poses), len(scan_poses),
        torch.tensor(map_poses, **f32), torch.tensor(scan_poses, **f32),
        [shard], torch.tensor(float(np.float32(lam)), dtype=torch.float64,
                              device=device))
    mp, sp, *stats = (t.cpu().numpy() for t in out)
    return mp[:M], sp[:N], [float(x) for x in stats]
