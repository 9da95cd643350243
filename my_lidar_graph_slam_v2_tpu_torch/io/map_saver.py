"""Map and pose-graph persistence.

Port of ``my_lidar_graph_slam_v2_tpu/io/map_saver.py``, logic unchanged
but for where the rasters live: a device raster comes to the host once
per saved map (:func:`_host`).  Equivalent of
``src/my_lidar_graph_slam/io/map_saver.cpp``: renders grid maps to PNG (gray = unknown, white = free, black = occupied, optional
trajectory overlay) with a JSON metadata sidecar, and saves the full pose
graph as JSON (per-node global/local poses, per-edge relative pose and
information matrix — sufficient to reconstruct and re-optimize, which is
also the checkpoint format, SURVEY.md section 5.4).

The PNG encoder is a minimal self-contained implementation (zlib +
struct) to avoid imaging dependencies.
"""
from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from ..core import pose as P
from ..graph.pose_graph import (
    CONSTRAINT_LOOP,
    CONSTRAINT_ODOMETRY,
    EDGE_INTER,
    EDGE_INTRA,
    LocalMapNode,
    PoseGraph,
    PoseGraphEdge,
    ScanNode,
)
from ..ops import pool


def _host(a) -> np.ndarray:
    """A raster as a host NumPy array: one device-to-host copy for a
    tensor."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def write_png_gray(path: str, img: np.ndarray):
    """8-bit grayscale PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def render_map(prob: np.ndarray, flip_y: bool = True) -> np.ndarray:
    """Occupancy probabilities (0 = unknown) -> grayscale image, matching
    the reference's rendering (unknown filled gray, occupied dark).
    Accepts f32 probabilities or u8 quantized levels (compacted maps)."""
    if prob.dtype == np.uint8:
        prob = prob.astype(np.float32) * (1.0 / 255.0)
    img = np.full(prob.shape, 192, np.uint8)  # unknown: gray
    known = prob > 0.0
    img[known] = np.clip((1.0 - prob[known]) * 255.0, 0, 255).astype(np.uint8)
    if flip_y:
        img = img[::-1]  # row 0 at the bottom (map y-up -> image y-down)
    return img


def save_map(
    raster,
    output_prefix: str,
    map_pose=None,
    trajectory=None,
):
    """PNG + metadata JSON like ``MapSaver::SaveMap``."""
    prob = _host(raster.prob)
    img = render_map(prob)
    if trajectory is not None and map_pose is not None:
        local = np.stack([P.inverse_compound(map_pose, t) for t in trajectory])
        rows = ((local[:, 1] - raster.offset_xy[1]) / raster.resolution).astype(int)
        cols = ((local[:, 0] - raster.offset_xy[0]) / raster.resolution).astype(int)
        ok = (rows >= 0) & (rows < prob.shape[0]) & (cols >= 0) & (cols < prob.shape[1])
        img[prob.shape[0] - 1 - rows[ok], cols[ok]] = 64
    write_png_gray(f"{output_prefix}.png", img)
    save_map_metadata(raster, output_prefix, map_pose)


def save_pose_graph(pose_graph, path: str):
    """Full graph JSON like ``MapSaver::SavePoseGraph``
    (map_saver.cpp:205-265)."""
    data = {
        "LocalMapNodes": [
            dict(
                Id=n.local_map_id,
                GlobalPose=[float(v) for v in n.global_pose],
                Finished=bool(n.finished),
            )
            for n in pose_graph.local_map_nodes
        ],
        "ScanNodes": [
            dict(
                Id=n.node_id,
                LocalMapId=n.local_map_id,
                LocalPose=[float(v) for v in n.local_pose],
                GlobalPose=[float(v) for v in n.global_pose],
                TimeStamp=(
                    float(n.scan_data.time_stamp) if n.scan_data else 0.0
                ),
            )
            for n in pose_graph.scan_nodes
        ],
        "Edges": [
            dict(
                LocalMapNodeId=e.local_map_node_id,
                ScanNodeId=e.scan_node_id,
                EdgeType="Inter" if e.edge_type else "Intra",
                ConstraintType="Loop" if e.is_loop else "Odometry",
                RelativePose=[float(v) for v in e.relative_pose],
                InformationMatrix=[
                    float(v) for v in np.asarray(e.information_mat).reshape(-1)
                ],
            )
            for e in pose_graph.edges
        ],
    }
    Path(path).write_text(json.dumps(data, indent=1))


def load_pose_graph(path: str):
    """Inverse of save_pose_graph: rebuild a PoseGraph (without scan data)
    — the checkpoint/restore path."""
    data = json.loads(Path(path).read_text())
    pg = PoseGraph()
    for n in data["LocalMapNodes"]:
        pg.local_map_nodes.append(
            LocalMapNode(n["Id"], np.asarray(n["GlobalPose"]), n["Finished"])
        )
    for n in data["ScanNodes"]:
        pg.scan_nodes.append(
            ScanNode(
                n["Id"],
                n["LocalMapId"],
                np.asarray(n["LocalPose"]),
                np.asarray(n["GlobalPose"]),
                None,
            )
        )
    for e in data["Edges"]:
        pg.edges.append(
            PoseGraphEdge(
                e["LocalMapNodeId"],
                e["ScanNodeId"],
                EDGE_INTER if e["EdgeType"] == "Inter" else EDGE_INTRA,
                CONSTRAINT_LOOP if e["ConstraintType"] == "Loop" else CONSTRAINT_ODOMETRY,
                np.asarray(e["RelativePose"]),
                np.asarray(e["InformationMatrix"]).reshape(3, 3),
            )
        )
    return pg


def save_map_and_scan(
    raster,
    output_prefix: str,
    map_pose,
    scan_global_pose=None,
    scan=None,
    trajectory=None,
):
    """``MapSaver::SaveLocalMapAndScan`` / ``SaveLatestMapAndScan``
    (map_saver.hpp:189-207): map PNG with the scan's hit points overlaid
    (dark dots) in addition to the trajectory."""
    prob = _host(raster.prob)
    img = render_map(prob)
    H, W = prob.shape

    def paint(points_local, value):
        rows = ((points_local[:, 1] - raster.offset_xy[1]) / raster.resolution).astype(int)
        cols = ((points_local[:, 0] - raster.offset_xy[0]) / raster.resolution).astype(int)
        ok = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
        img[H - 1 - rows[ok], cols[ok]] = value

    if trajectory is not None:
        local = np.stack([P.inverse_compound(map_pose, t) for t in trajectory])
        paint(local, 64)
    if scan is not None and scan_global_pose is not None:
        sensor_g = P.compound(np.asarray(scan_global_pose),
                              np.asarray(scan.relative_sensor_pose))
        sensor_l = P.inverse_compound(np.asarray(map_pose), sensor_g)
        r = np.asarray(scan.ranges)
        a = np.asarray(scan.angles)
        hx = sensor_l[0] + r * np.cos(sensor_l[2] + a)
        hy = sensor_l[1] + r * np.sin(sensor_l[2] + a)
        paint(np.stack([hx, hy], -1), 0)
    write_png_gray(f"{output_prefix}.png", img)
    save_map_metadata(raster, output_prefix, map_pose)


def save_map_metadata(raster, output_prefix: str, map_pose=None):
    """The map's JSON sidecar (rows, cols, resolution, offset and global
    pose); reads the raster's shape only."""
    prob = raster.prob
    meta = dict(
        Map=dict(
            Rows=int(prob.shape[0]),
            Cols=int(prob.shape[1]),
            Resolution=float(raster.resolution),
            OffsetX=float(raster.offset_xy[0]),
            OffsetY=float(raster.offset_xy[1]),
        ),
    )
    if map_pose is not None:
        meta["GlobalMapPose"] = [float(v) for v in map_pose]
    Path(f"{output_prefix}.json").write_text(json.dumps(meta, indent=1))


def save_local_maps(builder, pose_graph, output_prefix: str,
                    trajectory=None, resolution=None):
    """``MapSaver::SaveLocalMaps`` (map_saver.hpp:181-186): one PNG (+
    metadata) per local map, named ``<prefix>.local-map-<id>``."""
    res = resolution if resolution is not None else builder.cfg.resolution
    ok = True
    for lm in builder.local_maps:
        node = pose_graph.local_map_nodes[lm.local_map_id]
        raster = lm.raster(res)
        prefix = f"{output_prefix}.local-map-{lm.local_map_id}"
        save_map(raster, prefix, node.global_pose, trajectory=trajectory)
    return ok


def save_precomputed_maps(raster, output_prefix: str, map_pose=None,
                          heights=(1, 2, 3, 4, 5, 6)):
    """``MapSaver::SavePrecomputedGridMaps`` (map_saver.hpp:210-214):
    dump the branch-and-bound coarse-map pyramid (sliding-window max at
    window 2^h) as one PNG per height, pooled on the raster's device."""
    prob = raster.prob
    for h in heights:
        win = 1 << h
        coarse = _host(pool.sliding_window_max2d(prob, win))
        img = render_map(coarse)
        write_png_gray(f"{output_prefix}.precomp-{win}.png", img)
    save_map_metadata(raster, f"{output_prefix}.precomp", map_pose)
