# The port's own copy of my_lidar_graph_slam_v2_tpu/network/slam_client.py, logic
# unchanged: the port imports nothing of the JAX package.
"""TCP visualization client, wire-compatible with the reference.

Re-implements ``src/my_lidar_graph_slam/network/slam_client.cpp`` /
``network/data_types.hpp:17-71``: a hand-rolled big-endian framed TCP
stream carrying grid-map parameters, timestamped pose arrays, and the
latest scan to an external visualization server.  Message layout:

* message type: u32 (0 StopSignal, 1 PoseArray, 2 Scan, 3 GridMapParams)
* PoseArray: u32 count, then count * 4 doubles (time, x, y, theta)
* Scan: u32 beam count; doubles time, sensor pose (3), min/max range,
  min/max angle; then ranges[], angles[]
* GridMapParams: resolution (d), block size (i32), subpixel scale (i32),
  min/max range (d), p_hit/p_miss (d), odds_hit/odds_miss (d)

All scalars big-endian (the reference's hton64/htond).
"""
from __future__ import annotations

import socket
import struct
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

MSG_STOP = 0
MSG_POSE_ARRAY = 1
MSG_SCAN = 2
MSG_GRID_MAP_PARAMS = 3


def _u32(v: int) -> bytes:
    return struct.pack(">I", v)


def _i32(v: int) -> bytes:
    return struct.pack(">i", v)


def _d(v: float) -> bytes:
    return struct.pack(">d", v)


def _darray(vals) -> bytes:
    return np.asarray(vals, ">f8").tobytes()


@dataclass
class GridMapParams:
    resolution: float = 0.05
    block_size: int = 16
    subpixel_scale: int = 100
    min_range: float = 0.01
    max_range: float = 20.0
    probability_hit: float = 0.62
    probability_miss: float = 0.46

    @property
    def odds_hit(self):
        return self.probability_hit / (1 - self.probability_hit)

    @property
    def odds_miss(self):
        return self.probability_miss / (1 - self.probability_miss)


class SlamClient:
    def __init__(self, server_address: str, server_port: int):
        self.address = server_address
        self.port = server_port
        self._sock: Optional[socket.socket] = None

    def connect(self) -> bool:
        try:
            self._sock = socket.create_connection((self.address, self.port), 5.0)
            return True
        except OSError:
            self._sock = None
            return False

    def disconnect(self) -> bool:
        if self._sock is not None:
            try:
                self._sock.sendall(_u32(MSG_STOP))
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        return True

    def _send(self, payload: bytes) -> bool:
        if self._sock is None:
            return False
        try:
            self._sock.sendall(payload)
            return True
        except OSError:
            return False

    def send_pose_array(self, times, poses) -> bool:
        """times: [N], poses: [N, 3]."""
        poses = np.asarray(poses)
        buf = np.empty((len(poses), 4))
        buf[:, 0] = np.asarray(times)
        buf[:, 1:] = poses
        return self._send(
            _u32(MSG_POSE_ARRAY) + _u32(len(poses)) + _darray(buf.reshape(-1))
        )

    def send_scan(self, scan) -> bool:
        """scan: sensor.data.ScanData."""
        payload = (
            _u32(MSG_SCAN)
            + _u32(scan.num_scans)
            + _d(scan.time_stamp)
            + _d(scan.relative_sensor_pose[0])
            + _d(scan.relative_sensor_pose[1])
            + _d(scan.relative_sensor_pose[2])
            + _d(scan.min_range)
            + _d(scan.max_range)
            + _d(scan.min_angle)
            + _d(scan.max_angle)
            + _darray(scan.ranges)
            + _darray(scan.angles)
        )
        return self._send(payload)

    def send_grid_map_params(self, p: GridMapParams) -> bool:
        payload = (
            _u32(MSG_GRID_MAP_PARAMS)
            + _d(p.resolution)
            + _i32(p.block_size)
            + _i32(p.subpixel_scale)
            + _d(p.min_range)
            + _d(p.max_range)
            + _d(p.probability_hit)
            + _d(p.probability_miss)
            + _d(p.odds_hit)
            + _d(p.odds_miss)
        )
        return self._send(payload)
