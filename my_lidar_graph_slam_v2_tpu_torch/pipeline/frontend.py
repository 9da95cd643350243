"""SLAM frontend: keyframe gating, filter chain, two-stage matching.

Port of ``my_lidar_graph_slam_v2_tpu/pipeline/frontend.py``
(``lidar_graph_slam_frontend.cpp:110-411``): keyframe gate, outlier
filter and interpolator, one fused match against the latest map,
degeneration check with odometry fallback or fusion, node + edge append,
backend trigger.  Host logic is unchanged; the scan's padded arrays go to
the frontend's device as f32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import pose as P
from ..grid.builder import pad_scan
from ..matching.types import (
    ScanArrays,
    ScanMatchingQuery,
)
from ..metrics.registry import MetricManager
from ..sensor.data import ScanData
from ..sensor.filters import (
    ScanAccumulator,
    ScanInterpolator,
    ScanOutlierFilter,
)
from ..utils.memory import physical_memory_usage
from ..utils.transfer import to_device


@dataclass(frozen=True)
class FrontendConfig:
    """Field for field the JAX package's ``FrontendConfig``."""

    initial_pose: tuple = (0.0, 0.0, 0.0)
    update_threshold_travel_dist: float = 0.5
    update_threshold_angle: float = 0.5
    update_threshold_time: float = 5.0
    loop_detection_threshold: float = 2.5
    degeneration_threshold: float = 10.0
    odometry_covariance_scale: float = 1e2
    fuse_odometry_covariance: bool = False
    use_scan_outlier_filter: bool = True
    use_scan_accumulator: bool = False
    use_scan_interpolator: bool = True
    beam_capacity: int = 512
    usable_range_min: float = 0.01
    usable_range_max: float = 20.0


class LidarGraphSlamFrontend:
    def __init__(
        self,
        cfg: FrontendConfig,
        scan_matcher,
        final_scan_matcher,
        device,
        outlier_filter: Optional[ScanOutlierFilter] = None,
        interpolator: Optional[ScanInterpolator] = None,
        accumulator: Optional[ScanAccumulator] = None,
        metrics: Optional[MetricManager] = None,
    ):
        self.cfg = cfg
        self.scan_matcher = scan_matcher
        self.final_scan_matcher = final_scan_matcher
        self.device = torch.device(device)
        self.outlier_filter = outlier_filter if cfg.use_scan_outlier_filter else None
        self.interpolator = interpolator if cfg.use_scan_interpolator else None
        self.accumulator = accumulator if cfg.use_scan_accumulator else None
        self.metrics = metrics or MetricManager.instance()

        self.process_count = 0
        self.input_count = 0
        self.last_odom_pose = np.zeros(3)
        self.accumulated_travel_dist = 0.0
        self.accumulated_angle = 0.0
        self.last_map_update_odom_pose = np.zeros(3)
        self.last_map_update_time = 0.0
        self.last_loop_detection_dist = 0.0

        # Series named for parity with the reference's frontend metrics
        # (lidar_graph_slam_frontend.cpp:14-65); times in microseconds.
        vs = self.metrics.value_sequence
        self._m_input_count = self.metrics.counter("Frontend.InputScanDataCount")
        self._m_process_count = self.metrics.counter("Frontend.ProcessCount")
        self._m_process_time = vs("Frontend.ProcessTime")
        self._m_process_scan_time = vs("Frontend.ProcessScanTime")
        self._m_setup_time = vs("Frontend.ScanDataSetupTime")
        self._m_matching_time = vs("Frontend.ScanMatchingTime")
        self._m_final_matching_time = vs("Frontend.FinalScanMatchingTime")
        self._m_data_update_time = vs("Frontend.DataUpdateTime")
        self._m_interval_travel = vs("Frontend.IntervalTravelDist")
        self._m_interval_angle = vs("Frontend.IntervalAngle")
        self._m_interval_time = vs("Frontend.IntervalTime")
        self._m_num_scans = vs("Frontend.NumOfScans")
        self._m_process_frame = vs("Frontend.ProcessFrame")
        self._m_memory_usage = vs("Frontend.PhysicalMemoryUsage")
        self._m_degeneration = self.metrics.counter("Frontend.DegenerationCount")
        self._m_matcher_failure = self.metrics.counter(
            "Frontend.MatcherFailureCount"
        )

    # ------------------------------------------------------------------
    def _scan_arrays(self, scan: ScanData) -> ScanArrays:
        r, a, m = pad_scan(scan, self.cfg.beam_capacity,
                           self.cfg.usable_range_min, self.cfg.usable_range_max)
        # For matching, all beams that survived the outlier filter are used
        # (the usable-range mask only gates map integration).
        n = min(scan.num_scans, self.cfg.beam_capacity)
        m2 = np.zeros_like(m)
        m2[:n] = True
        return ScanArrays(
            to_device(r, self.device),
            to_device(a, self.device),
            to_device(m2, self.device),
            rel_sensor_pose=np.asarray(scan.relative_sensor_pose, np.float64),
            num_valid=n,
            max_range=float(r[:n].max()) if n else 0.0,
        )

    # ------------------------------------------------------------------
    def process_scan(self, parent, raw_scan: ScanData, odom_pose) -> bool:
        with self.metrics.span("Frontend.ProcessTime",
                               self._m_process_time) as total:
            return self._process_scan(parent, raw_scan, odom_pose, total)

    def _process_scan(self, parent, raw_scan, odom_pose, total) -> bool:
        span = self.metrics.span
        cfg = self.cfg
        odom_pose = np.asarray(odom_pose, np.float64)
        rel_odom = (
            np.zeros(3)
            if self.process_count == 0 and self.input_count == 0
            else P.inverse_compound(self.last_odom_pose, odom_pose)
        )
        self.last_odom_pose = odom_pose
        self.accumulated_travel_dist += float(P.distance(rel_odom))
        self.accumulated_angle += abs(float(rel_odom[2]))
        self.input_count += 1
        self._m_input_count.increment()

        if self.accumulator is not None:
            self.accumulator.append_scan(raw_scan)

        elapsed = (0.0 if self.process_count == 0
                   else raw_scan.time_stamp - self.last_map_update_time)
        update_needed = (
            self.accumulated_travel_dist >= cfg.update_threshold_travel_dist
            or self.accumulated_angle >= cfg.update_threshold_angle
            or elapsed >= cfg.update_threshold_time
            or self.process_count == 0
        ) and elapsed >= 0.0
        if not update_needed:
            return False

        self._m_interval_travel.observe(self.accumulated_travel_dist)
        self._m_interval_angle.observe(self.accumulated_angle)
        self._m_interval_time.observe(elapsed)

        scan = (self.accumulator.compute_concatenated_scan()
                if self.accumulator is not None else raw_scan)
        with span("Frontend.ScanDataSetupTime", self._m_setup_time
                  if self.process_count > 0 else None):
            if self.outlier_filter is not None:
                scan = self.outlier_filter.remove_outliers(scan)
            if self.interpolator is not None:
                scan = self.interpolator.interpolate(scan)

        if self.process_count == 0:
            with span("mapping.update", self._m_data_update_time):
                parent.append_first_node_and_edge(
                    np.asarray(cfg.initial_pose, np.float64), scan
                )
        else:
            parent.wait_for_optimization()
            # Single-sequence path: hand the matcher the latest map as raw
            # fold inputs (models/fused_matcher.py).
            fold_data = None
            if getattr(self.scan_matcher, "supports_deltas", False):
                fold_data = parent.get_latest_match_data()
            if fold_data is not None:
                latest_scan_pose, fold, latest_map_pose = fold_data
                latest_map = None
            else:
                latest_scan_pose, latest_map, latest_map_pose = (
                    parent.get_latest_data()
                )

            rel_from_last_update = P.inverse_compound(
                self.last_map_update_odom_pose, odom_pose
            )
            initial_pose = P.compound(latest_scan_pose, rel_from_last_update)
            map_local_initial = P.inverse_compound(latest_map_pose, initial_pose)

            scan_arrays = self._scan_arrays(scan)
            with span("frontend.match", self._m_matching_time):
                if fold_data is not None:
                    summary = self.scan_matcher.optimize_pose_deltas(
                        fold, scan_arrays, map_local_initial
                    )
                else:
                    summary = self.scan_matcher.optimize_pose(
                        ScanMatchingQuery(latest_map, scan_arrays,
                                          map_local_initial)
                    )
            with span("Frontend.FinalScanMatchingTime",
                      self._m_final_matching_time):
                if summary.pose_found:
                    if getattr(self.scan_matcher, "fused", False):
                        final_summary = summary
                    else:
                        final_summary = self.final_scan_matcher.optimize_pose(
                            ScanMatchingQuery(latest_map, scan_arrays,
                                              summary.estimated_pose)
                        )

            if not summary.pose_found:
                # Odometry fallback (the reference asserts here,
                # lidar_graph_slam_frontend.cpp:219).
                self._m_matcher_failure.increment()
                relative = rel_from_last_update
                covariance = self._odometry_covariance(
                    rel_from_last_update, elapsed
                )
            else:
                global_estimated = P.compound(
                    latest_map_pose, final_summary.estimated_pose
                )
                scan_relative = P.inverse_compound(
                    latest_scan_pose, global_estimated
                )
                scan_cov_world = P.covariance_local_to_world(
                    latest_map_pose, final_summary.covariance
                )
                if self._check_degeneration(scan_cov_world):
                    self._m_degeneration.increment()
                    odom_cov = self._odometry_covariance(
                        rel_from_last_update, elapsed
                    )
                    if cfg.fuse_odometry_covariance:
                        relative, covariance = self._fuse_odometry(
                            rel_from_last_update, odom_cov,
                            scan_relative, scan_cov_world,
                        )
                    else:
                        relative, covariance = rel_from_last_update, odom_cov
                else:
                    relative, covariance = scan_relative, scan_cov_world

            with span("mapping.update", self._m_data_update_time):
                parent.append_node_and_edge(relative, covariance, scan)

            accum = parent.accum_travel_dist()
            if accum - self.last_loop_detection_dist >= cfg.loop_detection_threshold:
                self.last_loop_detection_dist = accum
                parent.notify_backend()

        self.process_count += 1
        self.accumulated_travel_dist = 0.0
        self.accumulated_angle = 0.0
        self.last_map_update_odom_pose = odom_pose
        self.last_map_update_time = raw_scan.time_stamp
        self._m_process_count.increment()
        self._m_process_scan_time.observe(total.us())
        self._m_num_scans.observe(scan.num_scans)
        self._m_process_frame.observe(self.process_count)
        self._m_memory_usage.observe(physical_memory_usage())
        return True

    # ------------------------------------------------------------------
    def _check_degeneration(self, cov: np.ndarray) -> bool:
        """Eigenvalue-ratio degeneration test
        (``lidar_graph_slam_frontend.cpp:335-349``)."""
        ev = np.linalg.eigvals(cov[:2, :2]).real
        ratio = ev.max() / ev.min() if ev.min() != 0 else np.inf
        return bool(ratio > self.cfg.degeneration_threshold)

    def _odometry_covariance(self, rel_pose, elapsed) -> np.ndarray:
        """``ComputeOdometryCovariance``
        (``lidar_graph_slam_frontend.cpp:352-370``)."""
        travel = float(P.distance(rel_pose))
        dt = max(elapsed, 1e-9)
        tv = max(0.1, travel / dt)
        rv = max(0.1, rel_pose[2] / dt)
        return (np.diag([tv * tv, tv * tv, rv * rv])
                * self.cfg.odometry_covariance_scale)

    def _fuse_odometry(self, odom_rel, odom_cov, scan_rel, scan_cov):
        """Information-weighted fusion
        (``lidar_graph_slam_frontend.cpp:372-411``)."""
        inv_o = np.linalg.inv(odom_cov)
        inv_s = np.linalg.inv(scan_cov)
        fused_cov = np.linalg.inv(inv_o + inv_s)
        t_o = P.normalize_angle(odom_rel[2])
        t_s = P.normalize_angle(scan_rel[2])
        diff = t_s - t_o
        if diff > np.pi:
            t_o += 2 * np.pi
        elif diff < -np.pi:
            t_o -= 2 * np.pi
        vo = np.array([odom_rel[0], odom_rel[1], t_o])
        vs = np.array([scan_rel[0], scan_rel[1], t_s])
        fused = fused_cov @ (inv_o @ vo + inv_s @ vs)
        fused[2] = P.normalize_angle(fused[2])
        return fused, fused_cov
