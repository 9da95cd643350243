# The port's own copy of my_lidar_graph_slam_v2_tpu/graph/pose_graph.py, logic
# unchanged: the port imports nothing of the JAX package.
"""Pose graph storage (host side).

Mirrors ``mapping/pose_graph.hpp`` / ``pose_graph_node.hpp`` /
``pose_graph_edge.hpp``: two node stores (local-map nodes with a global
pose; scan nodes with global + map-local pose and the scan data) and a
bipartite edge list (every edge connects one local-map node and one scan
node; type intra/inter x odometry/loop, relative pose + 3x3 information
matrix).

Storage is structure-of-arrays so the optimizer can snapshot node poses and
edge tables as dense arrays without conversion loops.  Node ids are dense
indices (the reference's ids are also consecutive ints; sparse IdMap
semantics are unnecessary here).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..sensor.data import ScanData

EDGE_INTRA, EDGE_INTER = 0, 1
CONSTRAINT_ODOMETRY, CONSTRAINT_LOOP = 0, 1


@dataclass
class LocalMapNode:
    local_map_id: int
    global_pose: np.ndarray  # (3,)
    finished: bool = False


@dataclass
class ScanNode:
    node_id: int
    local_map_id: int
    local_pose: np.ndarray  # (3,) pose in the local map frame
    global_pose: np.ndarray  # (3,)
    scan_data: Optional[ScanData] = None


@dataclass
class PoseGraphEdge:
    local_map_node_id: int
    scan_node_id: int
    edge_type: int  # EDGE_INTRA / EDGE_INTER
    constraint_type: int  # CONSTRAINT_ODOMETRY / CONSTRAINT_LOOP
    relative_pose: np.ndarray  # (3,)
    information_mat: np.ndarray  # (3, 3)

    @property
    def is_odometry(self) -> bool:
        return self.constraint_type == CONSTRAINT_ODOMETRY

    @property
    def is_loop(self) -> bool:
        return self.constraint_type == CONSTRAINT_LOOP


@dataclass
class PoseGraph:
    local_map_nodes: List[LocalMapNode] = field(default_factory=list)
    scan_nodes: List[ScanNode] = field(default_factory=list)
    edges: List[PoseGraphEdge] = field(default_factory=list)

    # ---- array snapshots (for the optimizer / loop search) -------------
    def local_map_poses(self) -> np.ndarray:
        return np.array([n.global_pose for n in self.local_map_nodes]).reshape(-1, 3)

    def scan_poses(self) -> np.ndarray:
        return np.array([n.global_pose for n in self.scan_nodes]).reshape(-1, 3)

    def edge_arrays(self, num_map_nodes=None, num_scan_nodes=None):
        """Dense edge tables, optionally restricted to a node-count prefix
        (the reference optimizes a snapshot cut at the first unfinished
        local map, ``lidar_graph_slam.cpp:107-192``)."""
        sel = [
            e
            for e in self.edges
            if (num_map_nodes is None or e.local_map_node_id < num_map_nodes)
            and (num_scan_nodes is None or e.scan_node_id < num_scan_nodes)
        ]
        if not sel:
            return (
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros((0, 3)),
                np.zeros((0, 3, 3)),
            )
        map_idx = np.array([e.local_map_node_id for e in sel], np.int32)
        scan_idx = np.array([e.scan_node_id for e in sel], np.int32)
        is_loop = np.array([e.is_loop for e in sel], np.int32)
        rel = np.stack([e.relative_pose for e in sel])
        info = np.stack([e.information_mat for e in sel])
        return map_idx, scan_idx, is_loop, rel, info
