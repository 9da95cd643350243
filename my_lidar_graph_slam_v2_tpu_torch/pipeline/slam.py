"""LidarGraphSlam facade: shared state + snapshot/mutator API.

Port of ``my_lidar_graph_slam_v2_tpu/pipeline/slam.py``
(``mapping/lidar_graph_slam.{hpp,cpp}``): owns the pose graph and the
grid map builder, serves the frontend's mutators, the backend's snapshots
(loop-search hint, detection queries, optimizable prefix) and the
loop-closure write-back with odometry-edge propagation of the
un-optimized suffix (lidar_graph_slam.cpp:508-654).

The backend step runs inline (deterministic mode) or on a worker thread
behind one lock, as in the JAX package, with one repair (ROADMAP 3.2): the
worker catches its own exceptions, a dead worker ends the frontend's
backpressure wait, and the error is raised to the frontend instead of
hanging it.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..core import pose as P
from ..graph.pose_graph import (
    CONSTRAINT_LOOP,
    EDGE_INTER,
    PoseGraph,
    PoseGraphEdge,
)
from ..grid.builder import GridMapBuilder
from ..metrics.registry import MetricManager
from ..sensor.data import ScanData


class LidarGraphSlam:
    def __init__(self, frontend, backend, builder: GridMapBuilder,
                 max_backend_lag: int = 24):
        self.frontend = frontend
        self.backend = backend
        self.builder = builder
        self.pose_graph = PoseGraph()
        self._lock = threading.RLock()
        self._backend_thread: Optional[threading.Thread] = None
        self._backend_notify = threading.Event()
        self._backend_stop = threading.Event()
        self.backend_error: Optional[BaseException] = None
        self.inline_backend = backend is not None and getattr(
            backend, "inline", True
        )
        # Optimization-in-progress protocol (lidar_graph_slam.cpp:832-860)
        self._opt_cond = threading.Condition()
        self._opt_running = False
        self.opt_wait_count = 0
        self.backend_thread_steps = 0
        # Backpressure: the frontend may run at most max_backend_lag
        # keyframes ahead of the last completed backend step (0 disables).
        self.max_backend_lag = max_backend_lag
        self._lag_cond = threading.Condition()
        self._backend_done_nodes = 0
        self.lag_wait_count = 0
        # Highest finished-map id whose loop search already ran
        self._loop_search_cursor = -1

    # ---- frontend entry ----------------------------------------------
    def process_scan(self, scan: ScanData, odom_pose: np.ndarray) -> bool:
        """Feed one scan; True when it became a keyframe.  With tracing on
        a keyframe closes the trace record (``metrics/registry.py``)."""
        mm = MetricManager.instance()
        with mm.span("process_scan"):
            keyframe = self.frontend.process_scan(self, scan, odom_pose)
        if keyframe:
            mm.close_record()
        return keyframe

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

    # ---- backend notification ----------------------------------------
    def notify_backend(self):
        if self.backend is None:
            return
        if self.inline_backend:
            # Drain: one step per pending finished map (cursor semantics)
            self.backend.run_step(self)
            while self.has_pending_loop_maps():
                self.backend.run_step(self)
        else:
            self._backend_notify.set()
            self.throttle_backend_lag()

    def _worker_alive(self) -> bool:
        return self._backend_thread is not None and self._backend_thread.is_alive()

    def throttle_backend_lag(self):
        """Block until the backend's last completed step is within
        ``max_backend_lag`` keyframes of the graph head, or the worker has
        died (then its error is raised).  The wait is observed into
        ``Frontend.BackendLagWaitTime`` (us)."""
        if self.inline_backend or self.backend is None:
            return
        mm = MetricManager.instance()
        name = "Frontend.BackendLagWaitTime"
        if self.max_backend_lag > 0:
            with self._lag_cond:
                if self._lagging():
                    self.lag_wait_count += 1
                    with mm.span(name, mm.value_sequence(name)):
                        while self._lagging():
                            self._lag_cond.wait(timeout=0.05)
        self._raise_backend_error()

    def _lagging(self) -> bool:
        return (len(self.pose_graph.scan_nodes) - self._backend_done_nodes
                > self.max_backend_lag
                and not self._backend_stop.is_set()
                and self._worker_alive())

    def _raise_backend_error(self):
        if self.backend_error is not None:
            raise RuntimeError("the backend worker died") from self.backend_error

    def notify_optimization_started(self):
        with self._opt_cond:
            self._opt_running = True

    def notify_optimization_done(self):
        with self._opt_cond:
            self._opt_running = False
            self._opt_cond.notify_all()

    def wait_for_optimization(self):
        """Block the frontend while the backend rewrites node poses
        (``WaitForOptimization``); observed into
        ``Frontend.OptimizationWaitTime`` (us)."""
        if self.inline_backend or self.backend is None:
            return
        mm = MetricManager.instance()
        name = "Frontend.OptimizationWaitTime"
        with mm.span(name, mm.value_sequence(name)):
            with self._opt_cond:
                if self._opt_running:
                    self.opt_wait_count += 1
                while self._opt_running:
                    self._opt_cond.wait()

    def start_backend(self):
        if self.backend is None or self.inline_backend:
            return

        def worker():
            try:
                while not self._backend_stop.is_set():
                    if self._backend_notify.wait(timeout=0.05):
                        self._backend_notify.clear()
                        self.backend.run_step(self)
                        self.backend_thread_steps += 1
                        with self._lag_cond:
                            self._backend_done_nodes = len(
                                self.pose_graph.scan_nodes
                            )
                            self._lag_cond.notify_all()
                        if self.has_pending_loop_maps():
                            self._backend_notify.set()
            except BaseException as e:  # noqa: BLE001 - handed to the frontend
                self.backend_error = e
            finally:
                with self._lag_cond:
                    self._lag_cond.notify_all()

        self._backend_thread = threading.Thread(target=worker, daemon=True,
                                                name="slam-backend")
        self._backend_thread.start()

    def stop_backend(self):
        """Finish (and compact) the last local map, fetch the out-of-extent
        hit count, then run the final backend passes over the finished
        graph (lidar_graph_slam_backend.cpp:86-89)."""
        with self._lock:
            if self.builder.local_maps:
                lm = self.builder.latest_local_map()
                lm.finished = True
                self.pose_graph.local_map_nodes[lm.local_map_id].finished = True
                if self.builder.cfg.compact_finished_maps:
                    lm.compact()
            self.builder.flush_oob()
        if self.backend is None:
            return
        if not self.inline_backend:
            self._backend_stop.set()
            if self._backend_thread is not None:
                self._backend_thread.join()
                self._backend_thread = None
            self._raise_backend_error()
        self.backend.run_step(self)
        while self.has_pending_loop_maps():
            self.backend.run_step(self)

    # ---- snapshots for the backend -----------------------------------
    def get_pose_graph_for_optimization(self):
        """Snapshot cut at the first unfinished local map
        (``GetPoseGraphForOptimization``, lidar_graph_slam.cpp:107-192):
        (num_map_nodes, num_scan_nodes, map_poses, scan_poses, edges)."""
        with self._lock:
            n_maps = 0
            for n in self.pose_graph.local_map_nodes:
                if not n.finished:
                    break
                n_maps += 1
            if n_maps == 0:
                return None
            n_scans = self.builder.local_maps[n_maps - 1].scan_node_id_max + 1
            map_poses = self.pose_graph.local_map_poses()[:n_maps].copy()
            scan_poses = self.pose_graph.scan_poses()[:n_scans].copy()
            edges = self.pose_graph.edge_arrays(n_maps, n_scans)
            return n_maps, n_scans, map_poses, scan_poses, edges

    def get_loop_search_hint(self):
        """Snapshot for the loop searcher (``GetLoopSearchHint``,
        lidar_graph_slam.cpp:273-381) with the JAX package's cursor: the
        query map is the oldest finished map not yet searched, and the
        travel distance is taken at that map's last node."""
        with self._lock:
            finished = [lm for lm in self.builder.local_maps if lm.finished]
            pending = [lm for lm in finished
                       if lm.local_map_id > self._loop_search_cursor]
            if not pending:
                return None
            query = pending[0]
            scan_poses = self.pose_graph.scan_poses()
            map_ranges = [
                (lm.local_map_id, lm.scan_node_id_min, lm.scan_node_id_max)
                for lm in finished
            ]
            upto = min(query.scan_node_id_max + 1, scan_poses.shape[0])
            seg = scan_poses[:upto, :2]
            accum_at_query = float(
                np.sum(np.hypot(np.diff(seg[:, 0]), np.diff(seg[:, 1])))
            ) if upto >= 2 else 0.0
            return dict(
                scan_poses=scan_poses,
                map_ranges=map_ranges,
                accum_travel_dist=accum_at_query,
                last_finished_map_id=query.local_map_id,
            )

    def mark_loop_search_processed(self, map_id: int):
        """Advance the loop-search cursor past ``map_id``."""
        with self._lock:
            self._loop_search_cursor = max(self._loop_search_cursor, map_id)

    def has_pending_loop_maps(self) -> bool:
        with self._lock:
            return any(
                lm.finished and lm.local_map_id > self._loop_search_cursor
                for lm in self.builder.local_maps
            )

    def get_loop_detection_queries(self, candidates):
        """Resolve candidate ids to (query scan node, reference local map,
        reference node) handles (``GetLoopDetectionQueries``)."""
        with self._lock:
            return [
                dict(
                    query_node=self.pose_graph.scan_nodes[c["query_node_id"]],
                    ref_node=self.pose_graph.scan_nodes[c["ref_node_id"]],
                    local_map=self.builder.local_map_at(c["ref_map_id"]),
                    local_map_node=self.pose_graph.local_map_nodes[
                        c["ref_map_id"]],
                )
                for c in candidates
            ]

    # ---- loop-closure write-back -------------------------------------
    def append_loop_closing_edges(self, results):
        """``AppendLoopClosingEdges`` (lidar_graph_slam.cpp:455-505)."""
        with self._lock:
            for res in results:
                self.pose_graph.edges.append(PoseGraphEdge(
                    res["local_map_id"],
                    res["scan_node_id"],
                    EDGE_INTER,
                    CONSTRAINT_LOOP,
                    P.normalize_pose(res["relative_pose"]),
                    np.linalg.inv(res["covariance"]),
                ))

    def after_loop_closure(self, n_maps, n_scans, map_poses, scan_poses):
        """Write back optimized poses, then re-derive the un-optimized
        suffix through odometry edges (``AfterLoopClosure``,
        lidar_graph_slam.cpp:508-654)."""
        with self._lock:
            pg = self.pose_graph
            for i in range(n_maps):
                pg.local_map_nodes[i].global_pose = map_poses[i].copy()
            for i in range(n_scans):
                pg.scan_nodes[i].global_pose = scan_poses[i].copy()

            processed_map = n_maps - 1
            processed_node = n_scans - 1
            start_idx = next(
                (idx for idx, e in enumerate(pg.edges)
                 if e.local_map_node_id == processed_map
                 and e.scan_node_id > processed_node),
                None,
            )
            if start_idx is not None:
                for e in pg.edges[start_idx:]:
                    if not e.is_odometry:
                        continue
                    if (e.local_map_node_id == processed_map
                            and e.scan_node_id > processed_node):
                        start_pose = pg.local_map_nodes[
                            e.local_map_node_id].global_pose
                        pg.scan_nodes[e.scan_node_id].global_pose = P.compound(
                            start_pose, e.relative_pose
                        )
                    elif (e.local_map_node_id > processed_map
                          and e.scan_node_id == processed_node):
                        end_pose = pg.scan_nodes[e.scan_node_id].global_pose
                        pg.local_map_nodes[e.local_map_node_id].global_pose = (
                            P.move_backward(end_pose, e.relative_pose)
                        )
                    processed_map = e.local_map_node_id
                    processed_node = e.scan_node_id
            self.builder.after_loop_closure(pg)

    # ---- end-of-run getters ------------------------------------------
    def get_global_map(self):
        with self._lock:
            return self.builder.construct_global_map(self.pose_graph)

    def get_latest_map(self):
        """(map pose, u8 raster) of the rebuilt latest map."""
        with self._lock:
            self.builder.update_latest_map(self.pose_graph)
            return self.builder.latest_map_pose.copy(), self.builder.latest_raster()

    def get_trajectory(self) -> np.ndarray:
        with self._lock:
            return self.pose_graph.scan_poses()

    def get_poses_with_times(self):
        """(times[N], poses[N,3]) of every scan node — the payload of the
        reference's ``GetPoses`` used by the TCP client
        (``slam_launcher.cpp:288-296``)."""
        with self._lock:
            times = np.array([
                nd.scan_data.time_stamp if nd.scan_data is not None else 0.0
                for nd in self.pose_graph.scan_nodes
            ])
            return times, self.pose_graph.scan_poses()

    def get_latest_scan(self):
        """Scan data of the newest scan node (``GetLatestScan``)."""
        with self._lock:
            nodes = self.pose_graph.scan_nodes
            return nodes[-1].scan_data if nodes else None
