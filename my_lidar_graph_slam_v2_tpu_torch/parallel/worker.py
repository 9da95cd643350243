"""Per-process entry of a multi-process SLAM run.

    python -m my_lidar_graph_slam_v2_tpu_torch.parallel.worker \\
        --init-method tcp://localhost:PORT --world-size 2 --rank K \\
        --backend gloo --device cpu [--smoke]

Port of ``scripts/multihost_worker.py``: every rank runs the same host
pipeline with the owner-routed backend
(``parallel/multihost.py:create_multihost_backend``), applies the
owner-retention policy after each scan, builds the owner-sharded global
map (not with ``--smoke``) and prints one JSON line with the JAX worker's
fields under the same names, plus the trajectory, the loop edges and the
counts per backend step.  ``--backend`` is required: gloo runs on the CPU
or on a GPU (several ranks may share one card), NCCL needs one GPU per
rank; a wrong pair raises.  ``--world office10`` is the JAX worker's 10 m
office (``--laps`` / ``--step``; ``--smoke`` cuts the shapes), ``--world
config3`` the world of ``scripts/eval_ate.py``'s config #3 (70 keyframes)
at the factory defaults.  The device defaults to the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def office10_sequence(laps: float, step: float, n_beams: int):
    """The JAX worker's world: a 10 m office, odometry noise (0.05, 0.02)."""
    from ..datasets import synthetic

    return synthetic.generate(
        synthetic.World.office(seed=21, size=10.0),
        synthetic.loop_trajectory(size=10.0, laps=laps, step=step),
        n_beams=n_beams, max_range=10.0, range_noise=0.01,
        odom_noise=(0.05, 0.02), seed=22,
    )


def config3_sequence(seed: int = 11, laps: float = 1.3):
    """The world of ``scripts/eval_ate.py``'s config #3: a 12 m office,
    ``laps`` laps at 8 cm steps, 181 beams to 12 m, odometry noise
    (0.05, 0.02)."""
    from ..scripts.eval_ate import sequence

    return sequence(laps, (0.05, 0.02), seed)


def _system(args, mesh):
    """(sequence, slam) of the chosen world on ``mesh``."""
    from ..pipeline.factory import create_default_slam
    from .multihost import create_multihost_backend

    device = mesh[0]
    if args.world == "config3":
        backend = create_multihost_backend(
            mesh, searcher_overrides=dict(travel_dist_threshold=6.0))
        return config3_sequence(), create_default_slam(device=device,
                                                       backend=backend)
    if args.smoke:
        n_theta, crop, beams, rows, spb, travel = 16, 128, 61, 256, 96, 1.0
    else:
        n_theta, crop, beams, rows, spb, travel = 48, 256, 121, 384, 192, 1.5
    backend = create_multihost_backend(
        mesh, usable_range_max=10.0, n_theta_max=n_theta, crop=crop,
        beam_capacity=256,
        searcher_overrides=dict(travel_dist_threshold=10.0,
                                node_dist_threshold=5.0),
    )
    slam = create_default_slam(
        device=device, map_rows=rows, map_cols=rows, beam_capacity=256,
        samples_per_beam=spb, usable_range_max=10.0, n_theta_max=n_theta,
        crop=crop, backend=backend,
        builder_overrides=dict(travel_dist_threshold=travel),
    )
    return office10_sequence(args.laps, args.step, beams), slam


def check_owner_sharded(r0: dict, r1: dict) -> None:
    """The owner-retention invariants of two ranks' results (the JAX
    package's ``tests/test_multihost.py:93-116``): aged-out rasters are
    held by their owner only, the union covers every map, both ranks
    dropped rasters once there are more than four maps, and scan buffers
    once there are more than 40 scan nodes.  Raises AssertionError."""
    all_maps = set(r0["all_map_ids"])
    held0, held1 = set(r0["rasters_held_ids"]), set(r1["rasters_held_ids"])
    if held0 | held1 != all_maps:
        raise AssertionError(f"rasters held {held0} | {held1} != {all_maps}")
    recent = set(sorted(all_maps)[-2:])
    if not held0 & held1 <= recent:
        raise AssertionError(f"old rasters held twice: {held0 & held1}")
    for r, held in ((r0, held0), (r1, held1)):
        foreign = [m for m in held - recent if m % 2 != r["process_id"]]
        if foreign:
            raise AssertionError(
                f"rank {r['process_id']} kept non-owned rasters {foreign}")
    if len(all_maps) > 4 and not (r0["dropped_rasters"]
                                  and r1["dropped_rasters"]):
        raise AssertionError("a rank dropped no raster")
    if r0["total_scan_nodes"] > 40 and any(
            r["scan_buffers_held"] >= r["total_scan_nodes"] for r in (r0, r1)):
        raise AssertionError("a rank dropped no scan buffer")


def run(args) -> dict:
    import torch.distributed as dist

    from ..datasets import synthetic
    from ..metrics.registry import MetricManager
    from ..ops import csm_cuda
    from . import multihost
    from .mesh import make_mesh

    device = torch.device(args.device)
    if args.backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device} requested and CUDA is not available")
    # Several ranks share the host's cores: one intra-op thread each.
    torch.set_num_threads(1)
    multihost.init_multihost(args.init_method, args.world_size, args.rank,
                             backend=args.backend)
    try:
        mesh = make_mesh([device])
        seq, slam = _system(args, mesh)
        backend = slam.backend
        ranks = backend.loop_detector.ranks
        detector = backend.loop_detector
        detect, detect_launches = detector.detect, []

        def counted(queries):
            n0 = csm_cuda.LAUNCHES
            out = detect(queries)
            detect_launches.append(csm_cuda.LAUNCHES - n0)
            return out

        detector.detect = counted
        gt = []
        dropped_rasters = dropped_scans = 0
        reruns = MetricManager.instance().counter("LoopDetector.DenseReruns")
        reruns0 = reruns.value
        launches0 = csm_cuda.LAUNCHES
        t0 = time.perf_counter()
        for scan, g in zip(seq.scans, seq.ground_truth):
            if slam.process_scan(scan, scan.odom_pose):
                gt.append(g)
            ret = multihost.apply_owner_retention(slam.pose_graph,
                                                  slam.builder)
            dropped_rasters += ret["dropped_rasters"]
            dropped_scans += ret["dropped_scans"]
        slam.stop_backend()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
        launches = csm_cuda.LAUNCHES - launches0
        collectives = ranks.calls
        est = slam.get_trajectory()
        loops = [(e.local_map_node_id, e.scan_node_id)
                 for e in slam.pose_graph.edges if e.is_loop]
        global_map_observed_cells = None
        if not args.smoke:
            _, gmap = multihost.construct_global_map_sharded(slam,
                                                             ranks=ranks)
            global_map_observed_cells = int(gmap.observed.sum())
        steps = max(backend.step_count, 1)
        return dict(
            process_id=args.rank,
            num_processes=dist.get_world_size(),
            global_devices=dist.get_world_size() * len(mesh),
            backend=args.backend,
            device=str(device),
            world=args.world,
            wall_s=round(wall_s, 2),
            scans=len(seq.scans),
            scans_per_sec=round(len(seq.scans) / max(wall_s, 1e-9), 2),
            keyframes=len(est),
            loops=len(loops),
            loop_edges=loops,
            ate=round(float(synthetic.ate_rmse(est, np.asarray(gt))), 5),
            trajectory_sum=round(float(np.abs(est).sum()), 4),
            trajectory=est.tolist(),
            rasterized_map_ids=sorted(detector.rasterized_map_ids),
            all_map_ids=sorted(lm.local_map_id
                               for lm in slam.builder.local_maps),
            rasters_held_ids=sorted(lm.local_map_id
                                    for lm in slam.builder.local_maps
                                    if lm.holds_raster),
            scan_buffers_held=sum(1 for n in slam.pose_graph.scan_nodes
                                  if n.scan_data is not None),
            total_scan_nodes=len(slam.pose_graph.scan_nodes),
            dropped_rasters=dropped_rasters,
            dropped_scans=dropped_scans,
            global_map_observed_cells=global_map_observed_cells,
            backend_steps=backend.step_count,
            dense_reruns=int(reruns.value - reruns0),
            csm_sweep_launches=launches,
            detects=len(detect_launches),
            detect_sweep_launches=sum(detect_launches),
            collectives=collectives,
            detect_sweep_launches_per_backend_step=sum(detect_launches) / steps,
            collectives_per_backend_step=collectives / steps,
        )
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-method", required=True,
                    help="e.g. tcp://localhost:29500")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default="cuda",
                    help="this rank's device (default: cuda)")
    ap.add_argument("--world", choices=("office10", "config3"),
                    default="office10")
    ap.add_argument("--laps", type=float, default=1.25)
    ap.add_argument("--step", type=float, default=0.3)
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes, no global map (a CI smoke run)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
