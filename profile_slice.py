#!/usr/bin/env python3
"""Where the frontend slice's time goes on one NVIDIA GPU.

    python3 profile_slice.py         # from the root of a checkout

Drives ``create_default_slam(device="cuda")`` at the factory defaults over
the 48-keyframe synthetic office sequence of ``chip_smoke.py`` (seed 0),
after the same warm-up, and prints one JSON object:

- ``keyframes_per_s``: one value per unfenced timed run (``REPEATS`` runs
  of the same sequence), the run-to-run spread of the end-to-end rate.
- ``layers_fenced``: each layer's calls and inclusive host ms per
  keyframe, from a run where every layer's call is bracketed by
  ``torch.cuda.synchronize()`` (so a layer's time includes its device
  work, and the sum runs slower than the unfenced run).
- ``launches_per_kf``, ``device_busy_ms_per_kf``, ``device_idle_share``
  and ``top_kernels``: from an unfenced run under ``torch.profiler``;
  busy time is the sum of device-side event durations (one stream, so
  they do not overlap), idle share is ``1 - busy / unfenced wall``.

Imports nothing of JAX.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke

REPEATS = 5


def _fenced_layers():
    """(owner, attribute, layer name) of every layer the fenced run times.
    Names start with their depth: 0 the facade, 1 the frontend's calls, 2
    the fused match's, 3 the correlative core's."""
    from my_lidar_graph_slam_v2_tpu_torch.grid import builder
    from my_lidar_graph_slam_v2_tpu_torch.matching import correlative
    from my_lidar_graph_slam_v2_tpu_torch.models import fused_matcher
    from my_lidar_graph_slam_v2_tpu_torch.ops import (
        csm, gauss_newton, pool, quant, rasterize,
    )
    from my_lidar_graph_slam_v2_tpu_torch.pipeline import slam

    B, F = builder.GridMapBuilder, fused_matcher.FusedCorrelativeGNMatcher
    return [
        (slam.LidarGraphSlam, "process_scan", "0 process_scan"),
        (B, "latest_fold_inputs", "1 fold inputs (host)"),
        (F, "optimize_pose_deltas", "1 fused match"),
        (B, "_integrate", "1 integrate scans (local map)"),
        (B, "prefill_latest_delta", "1 prefill latest delta"),
        (rasterize, "fold_shifted_deltas", "2 fold (latest map)"),
        (quant, "quantize_prob", "2 quantize (match + compact)"),
        (fused_matcher, "correlative_core", "2 correlative core"),
        (gauss_newton, "refine", "2 refine (GN and covariance)"),
        (gauss_newton, "covariance", "2 covariance (all)"),
        (correlative, "cost_at", "3 cost at winner"),
        (correlative, "covariance_at", "3 covariance at winner"),
        (csm, "sweep_input_window", "3 sweep windows"),
        (pool, "sliding_window_max2d", "3 pool"),
        (csm, "sweep", "3 csm_sweep (dispatch + kernel)"),
    ]


def fenced_run(device, seq):
    """One run with every layer of :func:`_fenced_layers` fenced by device
    syncs; returns {layer: [calls, seconds]}."""
    acc = {}
    saved = []

    def fence(owner, attr, name):
        fn = getattr(owner, attr)

        def timed(*args, **kw):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize(device)
                n, s = acc.get(name, (0, 0.0))
                acc[name] = (n + 1, s + time.perf_counter() - t)

        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    try:
        for owner, attr, name in _fenced_layers():
            fence(owner, attr, name)
        run = chip_smoke.run_slice(device, seq)
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
    return run, acc


def profiled_run(device, seq):
    """One unfenced run under ``torch.profiler``: device-side events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = chip_smoke.run_slice(device, seq)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device events")
    return run, by_name


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_slice: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke._nvidia_smi()
    print(f"device: {smi}", flush=True)

    seq = chip_smoke.build_sequence(chip_smoke.KEYFRAMES)
    chip_smoke.run_slice(device, chip_smoke.build_sequence(4, seed=1))
    runs = [chip_smoke.run_slice(device, seq) for _ in range(REPEATS)]
    n_kf = len(runs[0]["est"])
    walls = [r["wall"] for r in runs]
    fenced, acc = fenced_run(device, seq)
    profiled, kernels = profiled_run(device, seq)

    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    median_wall = sorted(walls)[len(walls) // 2]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({
        "device": smi,
        "keyframes": n_kf,
        "scans": len(seq.scans),
        "keyframes_per_s": [n_kf / w for w in walls],
        "unfenced_ms_per_kf": [1e3 * w / n_kf for w in walls],
        "fenced_wall_ms_per_kf": 1e3 * fenced["wall"] / n_kf,
        "profiled_wall_ms_per_kf": 1e3 * profiled["wall"] / n_kf,
        "layers_fenced": {
            name: {"calls_per_kf": n / n_kf, "ms_per_kf": 1e3 * s / n_kf}
            for name, (n, s) in sorted(acc.items())
        },
        "launches_per_kf": sum(n for n, _ in kernels.values()) / n_kf,
        "device_busy_ms_per_kf": busy_ms / n_kf,
        "device_idle_share": 1.0 - busy_ms / (1e3 * median_wall),
        "top_kernels": {
            name[:80]: {"n_per_kf": n / n_kf, "ms_per_kf": us / 1e3 / n_kf}
            for name, (n, us) in top
        },
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
