"""Multi-device scaling of the two sharded paths.

Port of the JAX package's ``scripts/eval_scaling.py``::

    python -m my_lidar_graph_slam_v2_tpu_torch.scripts.eval_scaling \\
        [--device cuda] [--devices 1 2 4] [--out F]

For each device count N of ``--devices`` (default: 1 and every power of
two up to the cards present) the mesh is the first N cards
(``parallel/mesh.py``), and two things are measured:

1. the loop-candidate fan-out: 2 N loop candidates, each against its own
   u8 map, split into one contiguous chunk per device and run as one
   batched correlative core per chunk (``parallel/loop_sharded.py:
   make_batched_loop_csm``, the coarse maps pooled over each crop), all
   results fetched once; candidates/s over 5 calls after a warm-up, and
   the scaling efficiency ``rate / (rate at 1 device * N)``;
2. ``DistributedPoseGraphOptimizer`` on the same mesh: seconds per
   ``optimize`` call on the JAX script's synthetic chain with loops (64
   maps, 1,024 scans, a loop edge every 8th scan).

The workload is the JAX script's: 1024 x 1024 maps, 512 beams and the
loop window (2.5 m x 2.5 m x 0.5 rad, T 128, crop 448) on a card; with
``--device cpu`` its small form (512 x 512, 256 beams, 1 m x 1 m x 0.3
rad, T 32, crop 256) on a mesh of N CPU entries, which share the host's
cores: there the numbers check the sharded path, not scaling.  More
devices than ``torch.cuda.device_count()`` are refused.  Prints one JSON
object with the card's name and power limit; writes it only to ``--out``.
The device defaults to the card and the script exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import common


def loop_workload(small: bool):
    """(CorrelativeConfig, map size, beams) of the JAX script."""
    from ..matching.correlative import CorrelativeConfig

    if small:
        return CorrelativeConfig(range_x=1.0, range_y=1.0, range_theta=0.3,
                                 n_theta_max=32, crop_rows=256,
                                 crop_cols=256), 512, 256
    return CorrelativeConfig(range_x=2.5, range_y=2.5, range_theta=0.5,
                             n_theta_max=128, crop_rows=448,
                             crop_cols=448), 1024, 512


def loop_inputs(C, H, B, seed=0):
    """NumPy inputs of C candidates, as the JAX script draws them: u8 maps
    (uniform probabilities, observed above 0.5), ranges 0.5-8 m, evenly
    spread angles, poses near the origin, the maps centred."""
    rng = np.random.default_rng(seed)
    prob = rng.uniform(0, 1, (C, H, H)).astype(np.float32)
    obs = prob > 0.5
    prob = np.round(np.where(obs, prob, 0.0) * 255.0).astype(np.uint8)
    ranges = rng.uniform(0.5, 8.0, (C, B)).astype(np.float32)
    angles = np.tile(np.linspace(-np.pi, np.pi, B).astype(np.float32), (C, 1))
    poses = rng.normal(0, 0.1, (C, 3)).astype(np.float32)
    offs = np.tile(np.float32([-H * 0.05 / 2] * 2), (C, 1))
    return dict(prob=prob, obs=obs, ranges=ranges, angles=angles,
                mask=np.ones((C, B), bool), poses=poses, offs=offs)


def bench_loop_fanout(mesh, *, small, batch_per_device=2, iters=5, seed=0):
    """Loop candidates/s over ``mesh``; also returns the found flags of
    the last call (in candidate order)."""
    from ..parallel.loop_sharded import make_batched_loop_csm
    from ..utils.transfer import fetch

    cfg, H, B = loop_workload(small)
    C = batch_per_device * len(mesh)
    inp = loop_inputs(C, H, B, seed)
    chunks = [c for c in np.array_split(np.arange(C), len(mesh))]
    staged = []
    for dev, c in zip(mesh, chunks):
        t = {k: torch.as_tensor(v[c], device=dev) for k, v in inp.items()}
        t["index"] = torch.arange(len(c), dtype=torch.int64, device=dev)
        staged.append(t)
    fn = make_batched_loop_csm(cfg)

    def call():
        outs = [fn(t["prob"], t["obs"], None, None, t["ranges"], t["angles"],
                   t["mask"], t["poses"], t["offs"], 0.0, 0.0, t["index"])
                for t in staged]
        return fetch(tuple(o[3] for o in outs))

    call()
    t0 = time.perf_counter()
    for _ in range(iters):
        found = call()
    dt = time.perf_counter() - t0
    return C * iters / dt, np.concatenate([np.asarray(f) for f in found])


def schur_graph(n_maps=64, n_scans=1024, seed=0):
    """The JAX script's synthetic graph: map and scan poses and the edges
    (map index, scan index, is loop, relative pose, information)."""
    rng = np.random.default_rng(seed)
    per_map = n_scans // n_maps
    map_poses = np.cumsum(rng.normal(0, 0.5, (n_maps, 3)), 0)
    scan_poses = np.repeat(map_poses, per_map, 0) + rng.normal(
        0, 0.05, (n_scans, 3))
    mi, si, il, rel, info = [], [], [], [], []
    for s in range(n_scans):
        m = s // per_map
        mi.append(m), si.append(s), il.append(False)
        rel.append(scan_poses[s] - map_poses[m] + rng.normal(0, 0.01, 3))
        info.append(np.eye(3) * 100.0)
    for s in range(0, n_scans, 8):
        m = max(0, s // per_map - 2)
        mi.append(m), si.append(s), il.append(True)
        rel.append(scan_poses[s] - map_poses[m] + rng.normal(0, 0.01, 3))
        info.append(np.eye(3) * 50.0)
    edges = (np.array(mi, np.int32), np.array(si, np.int32),
             np.array(il, bool), np.array(rel), np.stack(info))
    return map_poses, scan_poses, edges


def bench_schur_lm(mesh, iters=5, seed=0):
    """Seconds per ``DistributedPoseGraphOptimizer.optimize`` on ``mesh``
    after a warm-up call; also returns the last call's stats."""
    from ..parallel.distributed import DistributedPoseGraphOptimizer

    map_poses, scan_poses, edges = schur_graph(seed=seed)
    opt = DistributedPoseGraphOptimizer(mesh)
    opt.optimize(map_poses, scan_poses, edges)
    t0 = time.perf_counter()
    for _ in range(iters):
        _, _, stats = opt.optimize(map_poses, scan_poses, edges)
    return (time.perf_counter() - t0) / iters, stats


def run(device, device_counts=None, iters=5):
    """The measurement at each device count; returns the result dict.
    Raises ValueError for more cards than the machine has."""
    from ..parallel.mesh import make_mesh

    device = torch.device(device)
    cuda = device.type == "cuda"
    n_avail = torch.cuda.device_count() if cuda else None
    if device_counts is None:
        top = n_avail if cuda else 1
        device_counts = sorted({1} | {d for d in (2, 4, 8, 16) if d <= top})
    if cuda and max(device_counts) > n_avail:
        raise ValueError(f"{max(device_counts)} devices asked for, "
                         f"{n_avail} present")
    results, base = [], None
    for n in device_counts:
        mesh = make_mesh([torch.device("cuda", i) for i in range(n)]
                         if cuda else ["cpu"] * n)
        rate, found = bench_loop_fanout(mesh, small=not cuda, iters=iters)
        schur_s, stats = bench_schur_lm(mesh, iters=iters)
        base = base if base is not None else rate
        results.append(dict(
            devices=n, loop_candidates_per_s=rate,
            scaling_efficiency=rate / (base * n),
            loop_candidates_found=int(found.sum()),
            loop_candidates=int(found.size), schur_lm_optimize_s=schur_s,
            schur_lm_iterations=stats["iterations"],
            schur_lm_error=stats["error"],
            workload="full" if cuda else "small"))
    return dict(
        common.card(device), device_count=n_avail, results=results,
        interpretation=(
            "loop_candidates_per_s: loop-closure CSM queries (the JAX "
            "script's maps and window) split over the mesh's devices, one "
            "batched core per device; scaling_efficiency = rate / (rate at "
            "1 device * n).  A CPU mesh's entries share the host's cores, "
            "so there the numbers check the sharded path, not scaling."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device type (default: cuda; cpu only when "
                    "asked for)")
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="device counts (default: 1 and powers of two up "
                    "to the cards present)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    device = common.script_device(args.device, "eval_scaling")
    try:
        out = run(device, args.devices, args.iters)
    except ValueError as e:
        print(f"eval_scaling: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
