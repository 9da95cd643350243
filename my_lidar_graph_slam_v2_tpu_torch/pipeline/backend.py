"""SLAM backend: loop search -> detection -> optimization -> write-back.

Port of ``my_lidar_graph_slam_v2_tpu/pipeline/backend.py``
(``LidarGraphSlamBackend::RunStep``, lidar_graph_slam_backend.cpp:93-198):
snapshot a loop-search hint, generate candidates, detect loops, append
loop edges, snapshot the optimizable prefix, optimize, write poses back.
The step is host orchestration; the device work sits in the detector and
the optimizer.  Metric series carry the reference's backend names.
"""
from __future__ import annotations

from typing import Optional

from ..metrics.registry import MetricManager


class LidarGraphSlamBackend:
    def __init__(self, loop_searcher, loop_detector, optimizer,
                 metrics: Optional[MetricManager] = None, inline: bool = True):
        self.loop_searcher = loop_searcher
        self.loop_detector = loop_detector
        self.optimizer = optimizer
        self.inline = inline
        self.step_count = 0
        m = self._mm = metrics or MetricManager.instance()
        vs = m.value_sequence
        self._m_process_time = vs("Backend.ProcessTime")
        self._m_process_step_time = vs("Backend.ProcessStepTime")
        self._m_search_setup_time = vs("Backend.LoopSearchSetupTime")
        self._m_search_time = vs("Backend.LoopSearchTime")
        self._m_detection_setup_time = vs("Backend.LoopDetectionSetupTime")
        self._m_detection_time = vs("Backend.LoopDetectionTime")
        self._m_append_time = vs("Backend.PoseGraphAppendTime")
        self._m_opt_setup_time = vs("Backend.OptimizationSetupTime")
        self._m_opt_time = vs("Backend.OptimizationTime")
        self._m_update_time = vs("Backend.PoseGraphUpdateTime")
        self._m_end_search_setup = vs("Backend.EndAtLoopSearchSetup")
        self._m_end_search = vs("Backend.EndAtLoopSearch")
        self._m_end_detection = vs("Backend.EndAtLoopDetection")
        self._m_end_closure = vs("Backend.EndAtLoopClosure")
        self._m_new_loop_edges = vs("LidarGraphSlam.NumOfNewLoopEdges")
        self._m_candidates = vs("Backend.NumOfCandidates")

    def run_step(self, parent) -> bool:
        """One backend pass; returns True if an optimization ran."""
        with self._mm.span("backend.step", self._m_process_time) as step:
            if not self._step(parent):
                return False
            self._m_process_step_time.observe(step.us())
            return True

    def _step(self, parent) -> bool:
        span = self._mm.span
        self.step_count += 1

        with span("Backend.LoopSearchSetupTime", self._m_search_setup_time):
            hint = parent.get_loop_search_hint()
        if hint is None:
            self._m_end_search_setup.observe(self.step_count)
            return False
        query_map_id = hint["last_finished_map_id"]

        with span("Backend.LoopSearchTime", self._m_search_time):
            candidates = self.loop_searcher.search(hint)
        self._m_candidates.observe(len(candidates))
        # The cursor advances before detection runs, so a failed detection
        # still consumes the query map (the JAX package does the same; see
        # ROADMAP 3.3).
        parent.mark_loop_search_processed(query_map_id)
        if not candidates:
            self._m_end_search.observe(self.step_count)
            return False

        with span("Backend.LoopDetectionSetupTime",
                  self._m_detection_setup_time):
            queries = parent.get_loop_detection_queries(candidates)

        with span("loop.detect", self._m_detection_time):
            results = self.loop_detector.detect(queries)
        if not results:
            self._m_end_detection.observe(self.step_count)
            return False

        with span("Backend.PoseGraphAppendTime", self._m_append_time):
            parent.append_loop_closing_edges(results)
        self._m_new_loop_edges.observe(len(results))

        with span("Backend.OptimizationSetupTime", self._m_opt_setup_time):
            snapshot = parent.get_pose_graph_for_optimization()
        if snapshot is None:
            return False
        # Block the frontend while poses are being rewritten
        # (NotifyOptimizationStarted/Done, lidar_graph_slam_backend.cpp:172-191)
        parent.notify_optimization_started()
        try:
            n_maps, n_scans, map_poses, scan_poses, edges = snapshot
            with span("graph.optimize", self._m_opt_time):
                map_opt, scan_opt, _ = self.optimizer.optimize(
                    map_poses, scan_poses, edges
                )
            with span("graph.write_back", self._m_update_time):
                parent.after_loop_closure(n_maps, n_scans, map_opt, scan_opt)
        finally:
            parent.notify_optimization_done()
        self._m_end_closure.observe(self.step_count)
        return True
