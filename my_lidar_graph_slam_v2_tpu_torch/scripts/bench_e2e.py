"""End-to-end SLAM pipeline throughput on the card.

The port of the JAX package's ``scripts/bench_e2e.py``: a multi-lap
office loop course sized to a target keyframe count (the reference's Intel
run has 1,404 keyscans) through the full pipeline of
``create_default_slam`` with the default backend (keyframe gate, filters,
incremental latest map, fused CSM + GN match, local and latest map
integration, loop search, batched detection, LM and write-back), and one
JSON result: keyframes/s, scans/s, ATE, per-stage mean and p90 ms, loop
edges, out-of-extent hits, host RSS and peak device memory::

    python -m my_lidar_graph_slam_v2_tpu_torch.scripts.bench_e2e \\
        --keyframes 1400 [--out result.json] [--device cuda]
    python -m my_lidar_graph_slam_v2_tpu_torch.scripts.bench_e2e \\
        --device cpu --keyframes 120

The JAX result's ``jit_cache_sizes`` has no counterpart (nothing here
compiles per shape); ``peak_device_mb`` is the card's counterpart of
``peak_rss_mb``.  The kernels are built before the clock starts, as the
launcher builds them, so ``wall_s`` holds no ``nvcc`` run.  The device
defaults to the card and the script exits 2 without one; ``--device cpu``
runs on the CPU.  The result goes to ``--out`` only where it is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import common


def build_sequence(target_keyframes: int, seed: int = 0, step: float = 0.08,
                   size: float = 18.0, keyframe_travel: float = 0.5):
    """Synthetic sequence long enough for ~target_keyframes at the
    frontend's travel gate: laps of an 18 m office, 181 beams to 30 m,
    odometry noise (0.01, 0.004); the JAX script's sequence, bit for bit."""
    from ..datasets import synthetic

    world = synthetic.World.office(seed=seed, size=size)
    one = synthetic.loop_trajectory(size=size, laps=1.0, step=step)
    per_lap = float(
        np.sum(np.hypot(np.diff(one[:, 0]), np.diff(one[:, 1])))
    )
    laps = target_keyframes * keyframe_travel * 1.06 / per_lap
    traj = synthetic.loop_trajectory(size=size, laps=laps, step=step)
    return synthetic.generate(
        world, traj, n_beams=181, max_range=30.0, range_noise=0.01,
        odom_noise=(0.01, 0.004), seed=seed,
    )


def _series_stats(values, scale=1e-3):
    """mean/p50/p90/max (ms if the series is in us) + sum (ms)."""
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return None
    return dict(
        n=int(v.size),
        mean_ms=round(float(v.mean()) * scale, 3),
        p50_ms=round(float(np.percentile(v, 50)) * scale, 3),
        p90_ms=round(float(np.percentile(v, 90)) * scale, 3),
        max_ms=round(float(v.max()) * scale, 3),
        total_ms=round(float(v.sum()) * scale, 1),
    )


def run(target_keyframes: int = 1400, seed: int = 0, threaded: bool = True,
        max_scans: int | None = None, progress: bool = True,
        builder_overrides: dict | None = None, *, device="cuda") -> dict:
    from ..datasets.synthetic import ate_rmse
    from ..graph.pose_graph import CONSTRAINT_LOOP
    from ..metrics.registry import MetricManager
    from ..ops import cuda_build
    from ..pipeline.factory import create_default_backend, create_default_slam
    from ..utils.memory import peak_memory_usage, physical_memory_usage

    device = torch.device(device)
    mm = MetricManager.instance()
    mm.reset_all()

    t_gen = time.time()
    seq = build_sequence(target_keyframes, seed=seed)
    scans = seq.scans if max_scans is None else seq.scans[:max_scans]
    gen_s = time.time() - t_gen

    if device.type == "cuda":
        cuda_build.build("csm_sweep", "hit_images")
        torch.cuda.reset_peak_memory_stats(device)
    backend = create_default_backend(device=device, inline=not threaded)
    slam = create_default_slam(device=device, backend=backend,
                               builder_overrides=builder_overrides)
    slam.start_backend()

    # The first keyframes are not excluded: like the reference's
    # wall-clock runs, one-off costs (CUDA context, library handles,
    # allocator growth) fall in them; warmup_first3_kf_s reports them.
    t0 = time.time()
    first_kf_done = None
    for i, scan in enumerate(scans):
        if slam.process_scan(scan, scan.odom_pose):
            if first_kf_done is None and slam.process_count >= 3:
                first_kf_done = time.time() - t0
        if progress and (i + 1) % 1000 == 0:
            print(
                f"  scan {i+1}/{len(scans)}  keyframes={slam.process_count} "
                f"({(i+1)/(time.time()-t0):.1f} scans/s)",
                file=sys.stderr,
            )
    slam.stop_backend()
    common.sync(device)
    wall = time.time() - t0

    traj = slam.get_trajectory()
    # Scan nodes <-> ground truth by the synthetic timestamps
    times, _ = slam.get_poses_with_times()
    dt = 0.1
    gt_idx = np.clip(np.round(times / dt).astype(int), 0,
                     len(seq.ground_truth) - 1)
    ate = ate_rmse(traj, seq.ground_truth[gt_idx])
    odom = np.stack([s.odom_pose for s in scans])
    ate_odom = ate_rmse(odom, seq.ground_truth[: len(scans)])

    n_loop_edges = sum(
        1 for e in slam.pose_graph.edges if e.constraint_type == CONSTRAINT_LOOP
    )

    stages = {}
    for name, metric in sorted(mm.metrics.items()):
        if name.endswith("Time") and hasattr(metric, "values"):
            st = _series_stats(metric.values)
            if st is not None:
                stages[name] = st

    slam.builder.flush_oob()
    oob = mm.counter("GridMapBuilder.OutOfExtentHits").value
    fallbacks = {
        name: int(c.value)
        for name, c in mm.metrics.items()
        if name.endswith("DenseFallbacks") and getattr(c, "value", 0)
    }
    keyframes = slam.process_count
    peak_mb = common.peak_device_mb(device)
    where = common.card(device)
    return {
        "metric": "e2e_pipeline_keyframes_per_sec",
        "value": round(keyframes / wall, 2),
        "unit": "keyframes/s",
        "platform": where["platform"],
        "device_kind": where["device_kind"],
        "threaded_backend": threaded,
        "keyframes": keyframes,
        "scans": len(scans),
        "scans_per_sec": round(len(scans) / wall, 1),
        "wall_s": round(wall, 1),
        "warmup_first3_kf_s": round(first_kf_done or 0.0, 1),
        "gen_s": round(gen_s, 1),
        "ate_rmse_m": round(ate, 4),
        "ate_odometry_m": round(ate_odom, 4),
        "loop_edges": n_loop_edges,
        "local_maps": len(slam.builder.local_maps),
        "out_of_extent_hits": int(oob),
        "dense_fallbacks": fallbacks,
        "opt_wait_count": slam.opt_wait_count,
        "lag_wait_count": slam.lag_wait_count,
        "max_backend_lag": slam.max_backend_lag,
        "backend_thread_steps": slam.backend_thread_steps,
        "rss_mb": round(physical_memory_usage() / 2**20, 1),
        "peak_rss_mb": round(peak_memory_usage() / 2**20, 1),
        "peak_device_mb": None if peak_mb is None else round(peak_mb, 1),
        "stages": stages,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--keyframes", type=int, default=1400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu only when asked "
                    "for)")
    ap.add_argument("--inline", action="store_true",
                    help="inline (synchronous) backend instead of threaded")
    ap.add_argument("--no-compact", action="store_true",
                    help="disable finished-map compaction (A/B)")
    ap.add_argument("--out", default=None,
                    help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    device = common.script_device(args.device, "bench_e2e")

    result = run(
        target_keyframes=args.keyframes,
        seed=args.seed,
        threaded=not args.inline,
        max_scans=args.max_scans,
        builder_overrides=(
            dict(compact_finished_maps=False) if args.no_compact else None
        ),
        device=device,
    )
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
