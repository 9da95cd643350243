"""ATE over the four configurations of the JAX package's BASELINE.json.

The port of ``scripts/eval_ate.py``.  Each configuration runs on the
deterministic synthetic world of the JAX script (a 12 m office, seed 11,
181 beams to 12 m, drifting odometry) with ground truth attached:

  #1 odometry-only CSM (no loop closure)
  #2 CSM + correlative loop detection + online pose-graph updates
  #3 branch-and-bound loop detection + full pose-graph optimization
  #4 multi-candidate loop search + a robust kernel (DCS)

::

    python -m my_lidar_graph_slam_v2_tpu_torch.scripts.eval_ate \\
        [--quick] [--out results.json] [--device cuda]

Prints a table and writes the results only where ``--out`` says.  The
device defaults to the card and the script exits 2 without one;
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import common

# The JAX script's branch-and-bound window: B&B's reference role is
# wide-window relocalization, so it gets a larger window and theta range
# than config #2's correlative 2.5 m window.
BRANCH_BOUND = dict(node_height_max=5, range_x=3.5, range_y=3.5,
                    range_theta=0.75, n_theta_max=160, crop_rows=448,
                    crop_cols=448)


def sequence(laps, odom_noise, seed=11):
    """The JAX script's world: a 12 m office, ``laps`` laps at 8 cm steps,
    181 beams to 12 m."""
    from ..datasets import synthetic

    world = synthetic.World.office(seed=seed, size=12.0)
    traj = synthetic.loop_trajectory(size=12.0, laps=laps, step=0.08)
    return synthetic.generate(
        world, traj, n_beams=181, max_range=12.0,
        range_noise=0.01, odom_noise=odom_noise, seed=seed + 1,
    )


def run_config(name, *, backend_kind, loss_kind=None, laps, odom_noise,
               searcher=None, seed=11, device="cuda"):
    from ..datasets import synthetic
    from ..graph.loss import LossFunction
    from ..loop.detector import LoopDetectorBranchBound
    from ..matching.branch_bound import BranchBoundConfig, ScanMatcherBranchBound
    from ..pipeline.factory import create_default_backend, create_default_slam

    device = torch.device(device)
    seq = sequence(laps, odom_noise, seed)
    backend = None
    if backend_kind is not None:
        opt = dict(loss=LossFunction(loss_kind, 0.01)) if loss_kind else {}
        backend = create_default_backend(
            device=device, usable_range_max=12.0, n_theta_max=128, crop=448,
            searcher_overrides=searcher or dict(travel_dist_threshold=6.0),
            optimizer_overrides=opt,
        )
        if backend_kind == "branchbound":
            # The JAX script sets ``scan_matcher`` on the default batched
            # detector, which never calls it, so its #3 runs correlative
            # detection (ROADMAP 3.5).  Here the branch-and-bound detector
            # is built with the script's window, around the default
            # backend's final matcher and thresholds.
            detector = backend.loop_detector
            backend.loop_detector = LoopDetectorBranchBound(
                detector.cfg,
                ScanMatcherBranchBound(BranchBoundConfig(**BRANCH_BOUND),
                                       device),
                detector.final, resolution=detector.resolution,
            )
    slam = create_default_slam(
        device=device, map_rows=768, map_cols=768, beam_capacity=512,
        samples_per_beam=512, usable_range_max=12.0,
        n_theta_max=128, crop=384, backend=backend,
    )
    slam.start_backend()
    gts = []
    t0 = time.time()
    for scan, gt in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gts.append(gt)
    slam.stop_backend()
    common.sync(device)
    wall = time.time() - t0
    est = slam.get_trajectory()
    gts = np.asarray(gts)
    odom = np.stack([s.odom_pose for s in seq.scans])
    n_loops = sum(1 for e in slam.pose_graph.edges if e.is_loop)
    return dict(
        config=name,
        keyframes=len(est),
        scans=len(seq.scans),
        wall_s=round(wall, 1),
        scans_per_s=round(len(seq.scans) / wall, 2),
        ate_m=round(synthetic.ate_rmse(est, gts), 4),
        ate_odometry_m=round(synthetic.ate_rmse(odom, seq.ground_truth), 4),
        loop_edges=n_loops,
    )


def configs(quick=False):
    """(name, run_config keywords) of the four configurations."""
    laps_short = 0.35 if quick else 0.5
    laps_loop = 1.15 if quick else 1.3
    loop = dict(laps=laps_loop, odom_noise=(0.05, 0.02))
    return [
        ("1-odometry-only-csm", dict(backend_kind=None, laps=laps_short,
                                     odom_noise=(0.03, 0.01))),
        ("2-csm-correlative-loop", dict(backend_kind="correlative", **loop)),
        ("3-branch-bound-loop", dict(backend_kind="branchbound", **loop)),
        ("4-multi-candidate-robust", dict(
            backend_kind="correlative", loss_kind="DCS",
            searcher=dict(travel_dist_threshold=6.0, num_candidate_nodes=6),
            **loop)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu only when asked "
                    "for)")
    ap.add_argument("--out", default=None,
                    help="write the results to this JSON file")
    args = ap.parse_args(argv)
    device = common.script_device(args.device, "eval_ate")

    results = [run_config(name, device=device, **kw)
               for name, kw in configs(args.quick)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    hdr = (f"{'config':<28} {'kf':>4} {'ATE[m]':>8} {'odomATE':>8} "
           f"{'loops':>5} {'scan/s':>7}")
    print(hdr)
    print("-" * len(hdr))
    for r in results:
        print(f"{r['config']:<28} {r['keyframes']:>4} {r['ate_m']:>8.4f} "
              f"{r['ate_odometry_m']:>8.4f} {r['loop_edges']:>5} "
              f"{r['scans_per_s']:>7}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
