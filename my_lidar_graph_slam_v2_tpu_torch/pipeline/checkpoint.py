"""Checkpoint / resume.

Port of ``my_lidar_graph_slam_v2_tpu/pipeline/checkpoint.py``: the
pose-graph JSON (``io/map_saver.py``) plus the held scan buffers (npz),
the held local-map rasters (npz: f32 log-odds, or the u8 form of a
compacted map, with the packed observed mask) and the builder and
frontend counters.

* ``save`` brings each raster to the host once.
* ``load`` puts the saved rasters back on the SLAM system's device; a
  local map without a saved raster is re-rasterized from its scans via
  the invariant map-local poses (``grid_map_builder.cpp:440-449``) when
  this process holds them, and restored dropped (poses and metadata only,
  ``LocalMap.drop_heavy``) otherwise.

Owner-sharded runs (``parallel/multihost.py``): each rank saves under its
own prefix only the heavy state it still holds, so the checkpoint's size
scales ~1/P too, and ``load`` gives back the state the retention policy
left.  One choice differs from the JAX package: a restored raster takes
its shape from the saved array, not from the configuration (ROADMAP 3.4).
Like the JAX package, the backend's state (the loop-search cursor, the
LM's kept lambda) is not saved.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..core import pose as P
from ..grid.builder import GridMapBuilder, LocalMap
from ..io import map_saver
from ..sensor.data import ScanData
from ..utils.transfer import to_device


def _packed(observed) -> np.ndarray:
    return np.packbits(observed.cpu().numpy(), axis=None)


def _unpacked(bits, shape, device) -> torch.Tensor:
    mask = np.unpackbits(bits, axis=None)[: shape[0] * shape[1]]
    return to_device(mask.reshape(shape).astype(bool), device)


def save(slam, prefix: str):
    # Mid-run snapshots carry the true out-of-extent count: the counter is
    # accumulated on the device and lands in the registry on flush.
    slam.builder.flush_oob()
    map_saver.save_pose_graph(slam.pose_graph, f"{prefix}.posegraph.json")
    scans = {}
    meta = []
    for n in slam.pose_graph.scan_nodes:
        s = n.scan_data
        if s is None:  # dropped by owner retention: another rank holds it
            continue
        scans[f"ranges_{n.node_id}"] = s.ranges
        scans[f"angles_{n.node_id}"] = s.angles
        meta.append(
            dict(
                node_id=n.node_id,
                sensor_id=s.sensor_id,
                time_stamp=s.time_stamp,
                odom_pose=[float(v) for v in s.odom_pose],
                rel_sensor_pose=[float(v) for v in s.relative_sensor_pose],
                min_range=s.min_range,
                max_range=s.max_range,
                min_angle=s.min_angle,
                max_angle=s.max_angle,
            )
        )
    np.savez_compressed(f"{prefix}.scans.npz", **scans)
    maps = {}
    for lm in slam.builder.local_maps:
        i = lm.local_map_id
        if lm.compacted:
            # The u8 form of a compacted finished map: a bit-exact round
            # trip by construction.
            maps[f"pq_{i}"] = lm.prob_q.cpu().numpy()
        elif lm.logodds is not None:
            maps[f"lo_{i}"] = lm.logodds.cpu().numpy()
        else:  # dropped on this rank: its owner saves it
            continue
        maps[f"obs_{i}"] = _packed(lm.observed)
    np.savez_compressed(f"{prefix}.maps.npz", **maps)
    fe = slam.frontend
    state = dict(
        scan_meta=meta,
        local_maps=[
            dict(
                id=lm.local_map_id,
                scan_min=lm.scan_node_id_min,
                scan_max=lm.scan_node_id_max,
                finished=lm.finished,
            )
            for lm in slam.builder.local_maps
        ],
        accum_travel_dist=slam.builder.accum_travel_dist,
        travel_dist_last_local_map=slam.builder.travel_dist_last_local_map,
        frontend=dict(
            process_count=fe.process_count,
            input_count=fe.input_count,
            accumulated_travel_dist=fe.accumulated_travel_dist,
            accumulated_angle=fe.accumulated_angle,
            last_odom_pose=[float(v) for v in fe.last_odom_pose],
            last_map_update_odom_pose=[
                float(v) for v in fe.last_map_update_odom_pose
            ],
            last_map_update_time=fe.last_map_update_time,
            last_loop_detection_dist=fe.last_loop_detection_dist,
        ),
    )
    Path(f"{prefix}.state.json").write_text(json.dumps(state, indent=1))


def load(slam, prefix: str):
    """Restore state into a freshly constructed SLAM system (the same
    configuration as at save time), on its builder's device."""
    pg = map_saver.load_pose_graph(f"{prefix}.posegraph.json")
    state = json.loads(Path(f"{prefix}.state.json").read_text())
    scans = np.load(f"{prefix}.scans.npz")
    maps_path = Path(f"{prefix}.maps.npz")
    maps = np.load(maps_path) if maps_path.exists() else {}
    for m in state["scan_meta"]:
        nid = m["node_id"]
        pg.scan_nodes[nid].scan_data = ScanData(
            m["sensor_id"],
            m["time_stamp"],
            np.asarray(m["odom_pose"]),
            np.zeros(3),
            np.asarray(m["rel_sensor_pose"]),
            m["min_range"],
            m["max_range"],
            m["min_angle"],
            m["max_angle"],
            scans[f"angles_{nid}"],
            scans[f"ranges_{nid}"],
        )
    slam.pose_graph = pg

    builder: GridMapBuilder = slam.builder
    dev = builder.device
    builder.local_maps = []
    cfg = builder.cfg
    for lm_meta in state["local_maps"]:
        mid = lm_meta["id"]
        key = next((k for k in (f"pq_{mid}", f"lo_{mid}") if k in maps), None)
        saved = maps[key] if key else None
        # The saved array's shape, not the configured one (ROADMAP 3.4).
        shape = (saved.shape if saved is not None
                 else (cfg.local_map_rows, cfg.local_map_cols))
        lo, obs, offset = builder._new_raster(*shape)
        lm = LocalMap(
            mid, lo, obs, offset,
            scan_node_id_min=lm_meta["scan_min"],
            scan_node_id_max=lm_meta["scan_max"],
            finished=lm_meta["finished"],
        )
        if saved is not None:
            lm.observed = _unpacked(maps[f"obs_{mid}"], shape, dev)
            if key.startswith("pq_"):
                lm.logodds, lm.prob_q, lm.compacted = None, to_device(saved, dev), True
            else:
                lm.logodds = to_device(saved, dev)
        else:
            entries = _map_scans(pg, state["local_maps"], mid,
                                 cfg.num_overlapped_scans)
            if entries is None:
                # Owner-sharded checkpoint: this rank never held the
                # map's heavy state; restore it as retention left it.
                lm.drop_heavy()
            else:
                lm.logodds, lm.observed = builder._integrate(
                    lo, obs, offset, pg.local_map_nodes[mid].global_pose,
                    entries)
        builder.local_maps.append(lm)
    builder.accum_travel_dist = state["accum_travel_dist"]
    builder.travel_dist_last_local_map = state["travel_dist_last_local_map"]

    fe = state["frontend"]
    slam.frontend.process_count = fe["process_count"]
    slam.frontend.input_count = fe["input_count"]
    slam.frontend.accumulated_travel_dist = fe.get("accumulated_travel_dist", 0.0)
    slam.frontend.accumulated_angle = fe.get("accumulated_angle", 0.0)
    slam.frontend.last_odom_pose = np.asarray(fe["last_odom_pose"])
    slam.frontend.last_map_update_odom_pose = np.asarray(
        fe["last_map_update_odom_pose"]
    )
    slam.frontend.last_map_update_time = fe["last_map_update_time"]
    slam.frontend.last_loop_detection_dist = fe["last_loop_detection_dist"]
    return slam


def _map_scans(pg, local_maps, mid, num_overlapped_scans):
    """(global pose, scan) of every scan of local map ``mid``, for a map
    saved without its raster.  Local maps seeded with overlapped scans at
    creation also hold scans before ``scan_min``
    (``grid_map_builder.cpp:252-276``).  Global poses come from the
    invariant map-local poses through each scan's own map node, so the
    rebuilt raster stays consistent after loop closures moved node poses.
    None when a scan is held by another rank (owner-sharded checkpoints)."""
    meta = local_maps[mid]
    scan_ids = list(range(meta["scan_min"], meta["scan_max"] + 1))
    if mid > 0:
        prev_max = local_maps[mid - 1]["scan_max"]
        n_seed = min(prev_max + 1, num_overlapped_scans)
        first = max(0, prev_max - (n_seed - 1))
        scan_ids = list(range(first, prev_max + 1)) + scan_ids
    entries = []
    for sid in scan_ids:
        node = pg.scan_nodes[sid]
        if node.scan_data is None:
            return None
        own_map = pg.local_map_nodes[node.local_map_id]
        entries.append((P.compound(own_map.global_pose, node.local_pose),
                        node.scan_data))
    return entries
