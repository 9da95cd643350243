"""LidarGraphSlam facade: shared state + the frontend's mutator API.

Port of ``my_lidar_graph_slam_v2_tpu/pipeline/slam.py``
(``mapping/lidar_graph_slam.{hpp,cpp}``) for a system with no backend:
it owns the pose graph and the grid map builder and serves the
frontend's mutators and snapshot getters.  The loop-closing backend (its
snapshots, write-back and worker thread) comes with the backend slice,
ROADMAP item 1.10.
"""
from __future__ import annotations

import threading

import numpy as np

from my_lidar_graph_slam_v2_tpu.graph.pose_graph import PoseGraph
from my_lidar_graph_slam_v2_tpu.sensor.data import ScanData

from ..grid.builder import GridMapBuilder


class LidarGraphSlam:
    def __init__(self, frontend, backend, builder: GridMapBuilder):
        if backend is not None:
            raise NotImplementedError(
                "the loop-closing backend is not ported yet (ROADMAP item "
                "1.10); build the system with backend=None"
            )
        self.frontend = frontend
        self.backend = None
        self.builder = builder
        self.pose_graph = PoseGraph()
        self._lock = threading.RLock()

    # ---- frontend entry ----------------------------------------------
    def process_scan(self, scan: ScanData, odom_pose: np.ndarray) -> bool:
        return self.frontend.process_scan(self, scan, odom_pose)

    @property
    def process_count(self) -> int:
        return self.frontend.process_count

    # ---- mutators (frontend side) ------------------------------------
    def append_first_node_and_edge(self, initial_pose, scan_data) -> bool:
        with self._lock:
            cov = np.diag([1e-9, 1e-9, 1e-9])
            inserted = self.builder.append_scan(
                self.pose_graph, initial_pose, cov, scan_data
            )
            self.builder.prefill_latest_delta(self.pose_graph)
            return inserted

    def append_node_and_edge(self, relative_pose, covariance, scan_data) -> bool:
        with self._lock:
            inserted = self.builder.append_scan(
                self.pose_graph, relative_pose, covariance, scan_data
            )
            self.builder.prefill_latest_delta(self.pose_graph)
            return inserted

    def get_latest_data(self):
        """Rebuild + return the latest rolling map and poses
        (``GetLatestData``, lidar_graph_slam.cpp:224-270)."""
        with self._lock:
            self.builder.update_latest_map(self.pose_graph)
            latest_scan_pose = self.pose_graph.scan_nodes[-1].global_pose.copy()
            latest_map_pose = self.builder.latest_map_pose.copy()
            return latest_scan_pose, self.builder.latest_raster(), latest_map_pose

    def get_latest_match_data(self):
        """Latest-map fold inputs + poses for the fused match; None when
        the incremental path does not apply."""
        with self._lock:
            fold = self.builder.latest_fold_inputs(self.pose_graph)
            if fold is None:
                return None
            latest_scan_pose = self.pose_graph.scan_nodes[-1].global_pose.copy()
            return latest_scan_pose, fold, fold["map_pose"].copy()

    def accum_travel_dist(self) -> float:
        with self._lock:
            return self.builder.accum_travel_dist

    # ---- backend hooks (no backend in this system) -------------------
    def notify_backend(self):
        return

    def wait_for_optimization(self):
        return

    def stop_backend(self):
        """Finish (and compact) the last local map and fetch the
        out-of-extent hit count, as the JAX facade does at shutdown."""
        with self._lock:
            if self.builder.local_maps:
                lm = self.builder.latest_local_map()
                lm.finished = True
                self.pose_graph.local_map_nodes[lm.local_map_id].finished = True
                if self.builder.cfg.compact_finished_maps:
                    lm.compact()
            self.builder.flush_oob()

    # ---- end-of-run getters ------------------------------------------
    def get_global_map(self):
        with self._lock:
            return self.builder.construct_global_map(self.pose_graph)

    def get_trajectory(self) -> np.ndarray:
        with self._lock:
            return self.pose_graph.scan_poses()
