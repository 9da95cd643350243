"""Head to head: the port against the reference C++ binary's recorded runs.

The port of the JAX package's ``scripts/head_to_head.py`` without the
binary: ``h2h/`` holds the Carmen logs (``synth{seed}.clf``), their ground
truth (``synth{seed}_gt.npy``), the settings the binary ran with
(``settings_lm.json``: the reference's default settings with its own LM
optimizer) and the binary's outputs (``ref_synth{seed}.posegraph.json``
and ``.metric.json``).  Per log this script runs the port's launcher on
the log with those settings and reports, for the binary and for the port,
keyframes, loop edges and ATE (SE(2)-aligned RMSE against ground truth,
nodes matched to it by timestamp), plus the optimizer cross-check: the
port's robust total error on the binary's final graph, in f64, against
the binary's recorded FinalError, and the port's LM re-optimizing that
graph::

    python -m my_lidar_graph_slam_v2_tpu_torch.scripts.head_to_head \\
        [--seeds 7 11 3] [--device cuda] [--workdir build/h2h]

The port's outputs go to ``--workdir``; the summary to ``--results``
(default ``h2h/results_h2h_torch.json``).  Nothing else in ``h2h/`` is
written.  The device defaults to the card and the script exits 2 without
one; ``--device cpu`` runs the launcher on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import common

H2H = common.REPO / "h2h"
SETTINGS = H2H / "settings_lm.json"

DT = 0.1  # synthetic scan period; keyframes are matched to gt by timestamp


def parse_posegraph(path: Path):
    """Both pose-graph JSON dialects: the reference's (dict keyed by id,
    space-separated pose strings; map_saver.cpp:205-265) and the port's
    (lists with numeric arrays).  Returns (time stamps, poses, loop
    edges), nodes sorted by time."""
    pg = json.load(open(path))
    nodes = []  # (timestamp, pose[3])
    sn = pg["ScanNodes"]
    items = sn.values() if isinstance(sn, dict) else sn
    for nd in items:
        gp = nd["GlobalPose"]
        pose = [float(v) for v in gp.split()] if isinstance(gp, str) else gp
        nodes.append((float(nd["TimeStamp"]), pose))
    nodes.sort(key=lambda n: n[0])
    loops = sum(1 for e in pg["Edges"]
                if str(e["ConstraintType"]).lower() in ("1", "loop"))
    return np.array([n[0] for n in nodes]), \
        np.array([n[1] for n in nodes]), loops


def evaluate(pg_path: Path, gt: np.ndarray):
    from ..datasets.synthetic import ate_rmse

    ts, poses, loops = parse_posegraph(pg_path)
    idx = np.round(ts / DT).astype(int)
    return dict(
        nodes=len(poses),
        loop_edges=int(loops),
        ate_m=float(ate_rmse(poses, gt[idx])),
    )


def run_ours(log_path, settings, out_prefix, device="cuda"):
    """Run the port's launcher on ``log_path`` in a subprocess; returns
    (wall seconds, the launcher's device report: kernel launches and peak
    device memory, or None on the CPU).  A failing launcher raises, with
    the end of its errors on stderr."""
    out_prefix = Path(out_prefix)
    out_prefix.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m",
           "my_lidar_graph_slam_v2_tpu_torch.pipeline.launcher",
           str(log_path), str(settings), str(out_prefix),
           "--device", str(device)]
    t0 = time.time()
    try:
        res = subprocess.run(cmd, check=True, capture_output=True,
                             env=common.child_env(),
                             cwd=out_prefix.parent, text=True)
    except subprocess.CalledProcessError as e:
        sys.stderr.write(e.stderr[-4000:] if e.stderr else "<no stderr>")
        raise
    wall = time.time() - t0
    report = None
    for line in res.stderr.splitlines():
        if line.startswith("device report "):
            report = json.loads(line[len("device report "):])
    return wall, report


def _reference_graph(ref_pg_path):
    """The binary's final graph: map and scan poses (f64, by node id) and
    the edges (map index, scan index, type, relative pose, information)."""
    pg = json.load(open(ref_pg_path))
    lm = {int(k): [float(v) for v in nd["GlobalPose"].split()]
          for k, nd in pg["LocalMapNodes"].items()}
    sn = {int(k): [float(v) for v in nd["GlobalPose"].split()]
          for k, nd in pg["ScanNodes"].items()}
    map_poses = np.array([lm[k] for k in sorted(lm)])
    scan_poses = np.array([sn[k] for k in sorted(sn)])
    mi, si, il, rel, info = [], [], [], [], []
    for e in pg["Edges"]:
        mi.append(int(e["LocalMapNodeId"]))
        si.append(int(e["ScanNodeId"]))
        il.append(int(e["ConstraintType"]))
        rel.append([float(v) for v in e["RelativePose"].split()])
        vals = [float(v) for v in e["InformationMatrix"].split()]
        if len(vals) == 6:
            # map_saver.cpp:220-232 stores the upper triangle row-major
            im = np.zeros((3, 3))
            im[np.triu_indices(3)] = vals
            im = im + np.triu(im, 1).T
        else:
            im = np.array(vals).reshape(3, 3)
        info.append(im)
    edges = (np.array(mi, np.int64), np.array(si, np.int64),
             np.array(il, np.int32), np.array(rel), np.array(info))
    return map_poses, scan_poses, edges


def robust_total_error(map_poses, scan_poses, edges):
    """``ComputeTotalError`` (pose_graph_optimizer_lm.cpp:418-452) in f64
    on the CPU, Huber 0.01, the information unclipped."""
    from ..graph.loss import LossFunction
    from ..graph.optimizer import _total_error

    mi, si, _, rel, info = edges

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64)

    return float(_total_error(
        f64(map_poses), f64(scan_poses), torch.as_tensor(mi),
        torch.as_tensor(si), f64(rel), f64(info), LossFunction()))


def optimizer_cross_check(ref_pg_path: Path, ref_metric_path: Path,
                          device="cpu"):
    """The port's robust total error on the binary's final graph against
    the binary's own recorded FinalError, and the error after the port's
    production LM (f32 inputs, information clip, Schur step; on
    ``device``) re-optimizes that graph, measured in f64."""
    from ..graph.optimizer import OptimizerConfig, PoseGraphOptimizer

    map_poses, scan_poses, edges = _reference_graph(ref_pg_path)
    ours_on_ref = robust_total_error(map_poses, scan_poses, edges)
    m = json.load(open(ref_metric_path))
    # metric JSON: flat dotted keys inside each section
    # (metric/metric.hpp:646-686 flattens "<group>.<name>")
    vs = m["ValueSequences"]
    ref_final = float(
        vs["PoseGraphOptimizerLM.FinalError"]["Values"].split()[-1])
    ref_initial = float(
        vs["PoseGraphOptimizerLM.InitialError"]["Values"].split()[-1])
    opt = PoseGraphOptimizer(OptimizerConfig(), device=device)
    mp2, sp2, _ = opt.optimize(map_poses, scan_poses, edges)
    return dict(
        our_error_on_ref_solution=ours_on_ref,
        ref_final_error=ref_final,
        ref_initial_error=ref_initial,
        our_reoptimized_error=robust_total_error(mp2, sp2, edges),
    )


def head_to_head(seed, workdir, device="cuda"):
    """One committed log: the binary's recorded result, the JAX package's
    (``h2h/tpu_synth{seed}.posegraph.json``), the port's run on ``device``
    (outputs under ``workdir`` with the prefix ``torch_synth{seed}``) and
    the optimizer cross-check."""
    gt = np.load(H2H / f"synth{seed}_gt.npy")
    ref_prefix = H2H / f"ref_synth{seed}"
    prefix = Path(workdir) / f"torch_synth{seed}"
    wall, report = run_ours(H2H / f"synth{seed}.clf", SETTINGS, prefix,
                            device=device)
    ours = evaluate(Path(f"{prefix}.posegraph.json"), gt)
    ours["wall_s"] = wall
    ours["device_report"] = report
    return dict(
        seed=seed,
        reference=evaluate(Path(f"{ref_prefix}.posegraph.json"), gt),
        jax_artifact=evaluate(H2H / f"tpu_synth{seed}.posegraph.json", gt),
        ours=ours,
        optimizer_cross_check=optimizer_cross_check(
            Path(f"{ref_prefix}.posegraph.json"),
            Path(f"{ref_prefix}.metric.json")),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 11, 3])
    ap.add_argument("--device", default="cuda",
                    help="the launcher's torch device (default: cuda; cpu "
                    "only when asked for)")
    ap.add_argument("--workdir", default=str(common.REPO / "build" / "h2h"),
                    help="where the port's outputs go")
    ap.add_argument("--results", default=str(H2H / "results_h2h_torch.json"))
    args = ap.parse_args(argv)
    device = common.script_device(args.device, "head_to_head")

    results = []
    for seed in args.seeds:
        print(f"--- seed {seed} ---")
        r = head_to_head(seed, args.workdir, device=device)
        print(f"  reference: {r['reference']}")
        print(f"  JAX:       {r['jax_artifact']}")
        print(f"  ours:      {r['ours']}")
        print(f"  optimizer x-check: {r['optimizer_cross_check']}")
        results.append(r)
    out = dict(
        description="head-to-head: the reference C++ binary's recorded "
                    "runs (h2h/ref_synth*) vs the PyTorch port on the same "
                    "Carmen logs and settings (LM optimizer)",
        settings="h2h/settings_lm.json",
        device=common.card(device),
        results=results,
    )
    with open(args.results, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.results}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
