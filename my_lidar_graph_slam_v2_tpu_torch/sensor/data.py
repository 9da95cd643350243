# The port's own copy of my_lidar_graph_slam_v2_tpu/sensor/data.py, logic
# unchanged: the port imports nothing of the JAX package.
"""Sensor data containers (host side, NumPy).

Mirrors ``sensor/sensor_data.hpp``: a scan is (ranges, angles, odometry
pose, relative sensor pose, min/max range/angle, timestamp); odometry data
is (pose, velocity, timestamp).  Hit-point projection helpers are provided
in vectorized form.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np


@dataclass
class OdometryData:
    sensor_id: str
    time_stamp: float
    pose: np.ndarray  # (3,)
    velocity: np.ndarray  # (3,)


@dataclass
class ScanData:
    sensor_id: str
    time_stamp: float
    odom_pose: np.ndarray  # (3,) robot odometry pose at capture
    velocity: np.ndarray  # (3,)
    relative_sensor_pose: np.ndarray  # (3,) robot->sensor
    min_range: float
    max_range: float
    min_angle: float
    max_angle: float
    angles: np.ndarray  # (N,)
    ranges: np.ndarray  # (N,)

    @property
    def num_scans(self) -> int:
        return len(self.ranges)

    def hit_points(self, sensor_pose: np.ndarray) -> np.ndarray:
        """(N, 2) hit points for a sensor pose — ``ScanData::HitPoint``."""
        ang = sensor_pose[2] + self.angles
        return np.stack(
            [
                sensor_pose[0] + self.ranges * np.cos(ang),
                sensor_pose[1] + self.ranges * np.sin(ang),
            ],
            axis=-1,
        )

    def copy_with(self, **kw) -> "ScanData":
        return replace(self, **kw)
