"""Scaling of the whole multi-process pipeline at P = 1 and P = 2.

Port of the JAX package's ``scripts/eval_scaling_pipeline.py``::

    python -m my_lidar_graph_slam_v2_tpu_torch.scripts.eval_scaling_pipeline \\
        [--device cuda] [--laps 1.25] [--step 0.3] [--smoke] [--out F]

Runs the same end-to-end SLAM run (``parallel/worker.py``: frontend,
fused match, map building, owner-routed loop detection, the distributed
Schur LM and owner retention, on the JAX worker's 10 m office) in one
process, then in two processes of one gloo group, every rank on
``--device`` (by default the one card, as ``chip_smoke.py`` runs two
ranks), and reports scans/s per configuration, the JAX script's
efficiency ``rate(P = 2) / rate(P = 1)`` (each process runs the whole
frontend, so ideal scaling holds the rate while the backend's work
splits), and whether both configurations end on the same ATE and
trajectory.  Processes that share one card, and its host's cores, say
nothing about scaling across cards: that needs a machine with several.
Prints one JSON object; writes it only to ``--out``.  The device defaults
to the card and the script exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time

from . import common


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_config(nproc, *, device, laps, step, smoke=False, timeout=900):
    """``nproc`` worker processes of one gloo group; returns each rank's
    JSON line.  Every process is killed if one fails or times out."""
    port = _free_port()
    cmd = [sys.executable, "-m",
           "my_lidar_graph_slam_v2_tpu_torch.parallel.worker",
           "--init-method", f"tcp://localhost:{port}",
           "--world-size", str(nproc), "--backend", "gloo",
           "--device", str(device), "--laps", str(laps), "--step", str(step)]
    if smoke:
        cmd.append("--smoke")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=common.REPO, env=common.child_env())
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"worker exit {p.returncode}: {err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return outs


def run(device, *, laps=1.25, step=0.3, smoke=False):
    """P = 1, then P = 2; returns the result dict."""
    t0 = time.perf_counter()
    r1 = run_config(1, device=device, laps=laps, step=step, smoke=smoke)
    r2 = run_config(2, device=device, laps=laps, step=step, smoke=smoke)
    p1 = r1[0]
    rate1 = p1["scans_per_sec"]
    # The ranks meet at every collective: the slowest sets the rate.
    rate2 = min(r["scans_per_sec"] for r in r2)
    keys = ("keyframes", "loops", "ate", "csm_sweep_launches", "collectives")
    return dict(
        common.card(device),
        metric="full_pipeline_scans_per_sec",
        description=(
            "end-to-end SLAM run (frontend, fused match, map building, "
            "owner-routed loop detection, distributed Schur LM, owner "
            "retention), the same workload in each configuration"),
        laps=laps, step=step, smoke=smoke,
        p1=dict(scans_per_sec=rate1, wall_s=p1["wall_s"],
                **{k: p1[k] for k in keys}),
        p2=dict(scans_per_sec=rate2, wall_s=max(r["wall_s"] for r in r2),
                per_process_scans_per_sec=[r["scans_per_sec"] for r in r2],
                **{k: r2[0][k] for k in keys[:3]},
                csm_sweep_launches=[r["csm_sweep_launches"] for r in r2],
                collectives=[r["collectives"] for r in r2]),
        ate_identical=abs(p1["ate"] - r2[0]["ate"]) < 1e-6,
        trajectory_identical=abs(p1["trajectory_sum"]
                                 - r2[0]["trajectory_sum"]) < 1e-3,
        ranks_bitwise_equal=r2[0]["trajectory"] == r2[1]["trajectory"],
        efficiency_p2=rate2 / rate1 if rate1 else None,
        interpretation=(
            "efficiency = rate(P=2) / rate(P=1); every process runs the "
            "whole frontend and the backend's work splits, so ideal scaling "
            "holds the rate.  All ranks here share one device and one "
            "host's cores: the number checks the multi-process path and "
            "says nothing about scaling across cards."),
        harness_wall_s=time.perf_counter() - t0,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="every rank's device (default: cuda; cpu only when "
                    "asked for)")
    ap.add_argument("--laps", type=float, default=1.25)
    ap.add_argument("--step", type=float, default=0.3)
    ap.add_argument("--smoke", action="store_true",
                    help="the workers' small shapes (a CI smoke run)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    device = common.script_device(args.device, "eval_scaling_pipeline")
    out = run(device, laps=args.laps, step=args.step, smoke=args.smoke)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
