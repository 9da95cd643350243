"""CSM scan-matching throughput on the card against the C++ CPU baseline.

The port of the JAX package's root ``bench.py``::

    python -m my_lidar_graph_slam_v2_tpu_torch.scripts.bench_csm [--device cuda]

The workload is ``bench.py``'s: the frontend's local window (0.25 m x
0.25 m x 0.5 rad at 5 cm, crop 320, at most 176 thetas) of Intel-like
scans against four 1024 x 1024 u8 latest maps.  Batches of 8 and 16 cases
go through the port's batched correlative core
(``matching/correlative.py:correlative_core_batch``: one coarse and one
fine sweep launch per batch, the maps as one stack with a map index per
case) with the inputs already on the device, and the rate is reported
beside the pinned rate of the C++ baseline (``BASELINE_CPU.json``, read
and never written; ``native/csm_baseline.cpp``, whose live rate is
measured in a subprocess, ``--cpu-only``).  Per-stage ms per batch come
from CUDA events around the port's own stages.  Prints one JSON line with
the JAX script's keys plus the card's name and power limit.

The device defaults to the card and the script exits 2 without one; the
CPU runs only when asked for (``--device cpu``), and its numbers are the
CPU's.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..matching.correlative import CorrelativeConfig
from . import common

BASELINE_CPU = common.REPO / "BASELINE_CPU.json"

# bench.py's window: crop 320 (the reference FPGA's map-window contract);
# 176 thetas bound this workload's theta window (16 m range: 161 rows).
FRONTEND_WINDOW = CorrelativeConfig(n_theta_max=176, crop_rows=320,
                                    crop_cols=320)
# Stages of the JAX script with no counterpart in the port.
NO_COUNTERPART = {
    "hit_images": "the port's sweep kernel gathers each beam's cell from "
                  "the map window; it builds no hit images",
}


def build_workload(seed=0, n_maps=4):
    """``bench.py:build_workload`` on the port, on the CPU: per case the
    u8 latest-map raster of three scans, a 512-capacity query scan and the
    query's map-local pose, as (MapRaster, ScanArrays, pose)."""
    from ..core import pose as P
    from ..datasets import synthetic
    from ..grid.builder import GridMapBuilder, GridMapBuilderConfig
    from ..matching.types import MapRaster, ScanArrays
    from ..ops import quant
    from ..sensor.filters import ScanInterpolator

    world = synthetic.World.office(seed=seed, size=16.0)
    traj = synthetic.loop_trajectory(size=16.0, laps=0.3, step=0.5)
    seq = synthetic.generate(world, traj, n_beams=181, max_range=16.0,
                             range_noise=0.01, seed=seed)
    interp = ScanInterpolator(dist_scans=0.05)
    builder = GridMapBuilder(
        GridMapBuilderConfig(latest_map_rows=1024, latest_map_cols=1024),
        "cpu")

    cases = []
    for i in range(n_maps):
        base = i * 3
        scans = [interp.interpolate(seq.scans[base + k]) for k in range(3)]
        poses = [seq.ground_truth[base + k] for k in range(3)]
        anchor = poses[0]
        lo, obs, off = builder._new_raster(1024, 1024)
        lo, obs = builder._integrate(lo, obs, off, anchor,
                                     list(zip(poses, scans)))
        raster = MapRaster(quant.quantize_prob(lo, obs), obs, 0.05, off)
        query = interp.interpolate(seq.scans[base + 1])
        r = np.zeros(512, np.float32)
        a = np.zeros(512, np.float32)
        m = np.zeros(512, bool)
        n = min(query.num_scans, 512)
        idx = np.linspace(0, query.num_scans - 1, n).astype(int)
        r[:n] = query.ranges[idx]
        a[:n] = query.angles[idx]
        m[:n] = True
        arrays = ScanArrays(torch.from_numpy(r), torch.from_numpy(a),
                            torch.from_numpy(m), np.zeros(3), n)
        local_pose = P.inverse_compound(anchor, poses[1])
        cases.append((raster, arrays, np.asarray(local_pose)))
    return cases


def stage_batch(cases, batch, device):
    """A batch on ``device``: cases cycled to ``batch``, the distinct maps
    as one stack ``[M, H, W]`` with each case's map index."""
    sel = [i % len(cases) for i in range(batch)]
    return dict(
        prob=torch.stack([c[0].prob for c in cases]).to(device),
        observed=torch.stack([c[0].observed for c in cases]).to(device),
        map_index=torch.tensor(sel, dtype=torch.int64, device=device),
        ranges=torch.stack([cases[i][1].ranges for i in sel]).to(device),
        angles=torch.stack([cases[i][1].angles for i in sel]).to(device),
        mask=torch.stack([cases[i][1].mask for i in sel]).to(device),
        poses=torch.as_tensor(np.stack([cases[i][2] for i in sel]),
                              dtype=torch.float32).to(device),
        offsets=torch.as_tensor(
            np.stack([np.asarray(cases[i][0].offset_xy) for i in sel]),
            dtype=torch.float32).to(device),
    )


def run_core(cfg, b):
    """The batched core with the coarse maps pooled over each crop (the
    per-call ``ComputeCoarserMap`` analog) and no score gates; returns
    its 9-tuple of device tensors."""
    from ..matching.correlative import correlative_core_batch

    return correlative_core_batch(
        cfg, b["prob"], b["observed"], None, None, b["ranges"], b["angles"],
        b["mask"], b["poses"], b["offsets"], 0.0, 0.0,
        map_index=b["map_index"])


def bench_device(cases, iters=20, batch=8, device="cuda", with_stages=True):
    """Matches/s of the batched core at ``batch`` with the inputs staged on
    ``device``: a synchronize before and after ``iters`` back-to-back
    calls, after one warm-up call.  Returns (rate, stages or None, the
    last call's outputs)."""
    device = torch.device(device)
    cfg = FRONTEND_WINDOW
    b = stage_batch(cases, batch, device)
    out = run_core(cfg, b)
    common.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run_core(cfg, b)
    common.sync(device)
    rate = iters * batch / (time.perf_counter() - t0)
    stages = bench_stages(cfg, b, batch, iters, device) if with_stages else None
    return rate, stages, out


class _StageClock:
    """Time of named stages while the context is open: each call of a
    patched function is bracketed by CUDA events on the current stream
    (read after one sync at the end), or by the host clock on the CPU,
    where the ops run synchronously.  ``name(args, kwargs)`` names a call's
    stage, and ``extra(args, kwargs)``, if given, sees each call."""

    def __init__(self, device, stages):
        self.device = device
        self.stages = stages  # (owner, attribute, name, extra or None)
        self.marks = {}
        self._saved = []

    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def __enter__(self):
        for owner, attr, name, extra in self.stages:
            fn = getattr(owner, attr)

            def timed(*args, _fn=fn, _name=name, _extra=extra, **kw):
                start = self._mark()
                out = _fn(*args, **kw)
                end = self._mark()
                self.marks.setdefault(_name(args, kw), []).append((start, end))
                if _extra is not None:
                    _extra(args, kw)
                return out

            self._saved.append((owner, attr, fn))
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        return False

    def ms(self):
        """Total ms per stage."""
        common.sync(self.device)
        if self.device.type == "cuda":
            return {k: sum(s.elapsed_time(e) for s, e in v)
                    for k, v in self.marks.items()}
        return {k: 1e3 * sum(e - s for s, e in v)
                for k, v in self.marks.items()}


def bench_stages(cfg, b, batch, iters, device):
    """Per-stage ms per batch of the core, from ``iters`` calls with the
    stages bracketed (:class:`_StageClock`), the GN refinement of each case
    from its input pose (10 iterations; the port refines one case per
    call), and on the card the sweeps' bound for these inputs
    (``common.sweep_bound``).  ``full_core`` is filled in from the
    throughput run; ``rest_of_core`` is the core's time outside the named
    stages in the bracketed run."""
    from ..matching import correlative
    from ..ops import csm, gauss_newton, pool

    def fixed(name):
        return lambda args, kw: name

    def sweep_name(args, kw):
        return "coarse_sweep" if kw["stride"] > 1 else "fine_sweep"

    first_sweeps = []  # the coarse and fine sweep of the first call

    def keep_first(args, kw):
        if len(first_sweeps) < 2:
            first_sweeps.append((args, kw))

    stages = [
        (csm, "theta_search_params", fixed("beam_cells"), None),
        (csm, "beam_cells", fixed("beam_cells"), None),
        (csm, "max_hit_multiplicity", fixed("int8_certificate"), None),
        (csm, "sweep_input_window", fixed("map_windows"), None),
        (pool, "sliding_window_max2d", fixed("coarse_pool_crop"), None),
        (csm, "sweep", sweep_name, keep_first),
        (correlative, "_top", fixed("topk_prune"), None),
        (correlative, "cost_at", fixed("cost_cov"), None),
        (correlative, "covariance_at", fixed("cost_cov"), None),
    ]
    run_core(cfg, b)
    common.sync(device)
    core = _StageClock(device, [(correlative, "correlative_core_batch",
                                 fixed("core"), None)])
    with core, _StageClock(device, stages) as clock:
        for _ in range(iters):
            run_core(cfg, b)
    per = {k: v / iters for k, v in clock.ms().items()}
    bracketed_core = core.ms()["core"] / iters

    maps = b["map_index"].tolist()

    def refine():
        for i, m in enumerate(maps):
            gauss_newton.gn_refine(
                b["prob"][m], b["observed"][m], b["ranges"][i],
                b["angles"][i], b["mask"][i], b["poses"][i], cfg.resolution,
                b["offsets"][i], max_iterations=10,
                convergence_threshold=1e-4, initial_lambda=1e-4)

    refine()
    common.sync(device)
    gn = _StageClock(device, [(gauss_newton, "gn_refine", fixed("gn"), None)])
    with gn:
        for _ in range(iters):
            refine()
    stage_ms = dict(per)
    stage_ms["rest_of_core"] = bracketed_core - sum(per.values())
    stage_ms["gn_refine_10it"] = gn.ms()["gn"] / iters
    stage_ms["full_core"] = None

    roofline = None  # a device metric: not on the CPU
    if device.type == "cuda":
        bounds = [common.sweep_call_bound(
            a[0], a[1], a[3], a[4], tile_h=kw["tile_h"], tile_w=kw["tile_w"])
            for a, kw in first_sweeps]
        bound_ms = sum(x[0] for x in bounds)
        sweep_ms = per["coarse_sweep"] + per["fine_sweep"]
        roofline = dict(
            sweep_ms=sweep_ms, bound_ms=bound_ms,
            bound_by=max(bounds)[1], pct_of_bound=100 * bound_ms / sweep_ms,
            note=("bound: each input byte of the two sweeps read once, each "
                  "output written once, one int32 add per valid beam and "
                  "offset, at the H100 SXM's 700 W peaks"),
        )
    return dict(stages_ms_per_batch=stage_ms, batch=batch,
                no_counterpart=NO_COUNTERPART, sweep_roofline=roofline)


def bench_cpu(cases, iters=3):
    """Matches/s of the C++ baseline (``native/csm_baseline.cpp``) on the
    same cases, the coarse precompute included in each match."""
    from ..native import cpu_correlative_search, cpu_precompute_coarse

    prepared = []
    for raster, arrays, pose in cases:
        fine = raster.prob.numpy().astype(np.float32)
        if raster.prob.dtype == torch.uint8 or fine.max() > 1.5:
            fine /= 255.0
        n = arrays.num_valid
        ranges = arrays.ranges.numpy()[:n]
        angles = arrays.angles.numpy()[:n]
        max_range = ranges.max()
        tt = 0.05 / max_range
        step_theta = float(np.arccos(1.0 - 0.5 * tt * tt))
        win_t = int(np.ceil(0.25 / step_theta))
        prepared.append((fine, ranges, angles, pose, step_theta, win_t,
                         np.asarray(raster.offset_xy)))
    t0 = time.perf_counter()
    count = 0
    for _ in range(iters):
        for fine, ranges, angles, pose, step_theta, win_t, off in prepared:
            coarse = cpu_precompute_coarse(fine, 5)
            cpu_correlative_search(
                fine, coarse, ranges, angles, pose, 0.05, off,
                3, 3, win_t, step_theta, 5,
            )
            count += 1
    return count / (time.perf_counter() - t0)


def pinned_cpu_baseline():
    """The committed CPU baseline rate (``BASELINE_CPU.json``); the live
    rate on a shared host swings with its load, so ``vs_baseline`` is taken
    against this pinned number."""
    with open(BASELINE_CPU) as f:
        return json.load(f)


def cpu_rate_live(timeout=1800):
    """The baseline's live rate, measured in a subprocess
    (``--cpu-only``)."""
    child = subprocess.run(
        [sys.executable, "-m", __spec__.name, "--cpu-only"],
        capture_output=True, text=True, timeout=timeout, cwd=common.REPO,
        env=common.child_env(), check=True,
    )
    return json.loads(child.stdout.strip().splitlines()[-1])["cpu_rate_live"]


def measure(device, cases=None):
    """The whole benchmark on ``device``: the result dict that
    :func:`main` prints."""
    device = torch.device(device)
    live = cpu_rate_live()
    pinned = pinned_cpu_baseline()["cpu_rate"]
    cases = build_workload() if cases is None else cases
    rate, stages, out = bench_device(cases, device=device)
    if not all(bool(torch.isfinite(o.to(torch.float32)).all()) for o in out):
        raise RuntimeError("the batched core returned non-finite values")
    stages["stages_ms_per_batch"]["full_core"] = 1e3 * stages["batch"] / rate
    rate16, _, _ = bench_device(cases, iters=12, batch=16, device=device,
                                with_stages=False)
    return {
        "metric": "csm_scan_matches_per_sec_per_chip",
        "value": rate,
        "unit": "matches/s",
        "vs_baseline": rate / pinned,
        "cpu_baseline_pinned": pinned,
        "cpu_baseline_live": live,
        **common.card(device),
        "value_batch16": rate16,
        "vs_baseline_batch16": rate16 / pinned,
        **stages,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu only when asked "
                    "for)")
    ap.add_argument("--cpu-only", action="store_true",
                    help="run only the C++ baseline and print its rate")
    args = ap.parse_args(argv)
    if args.cpu_only:
        print(json.dumps({"cpu_rate_live": bench_cpu(build_workload())}))
        return 0
    device = common.script_device(args.device, "bench_csm")
    print(json.dumps(measure(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
