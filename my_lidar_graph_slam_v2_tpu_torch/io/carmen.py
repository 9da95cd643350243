# The port's own copy of my_lidar_graph_slam_v2_tpu/io/carmen.py, logic
# unchanged but for ``native=None`` (see read_carmen_log): the port
# imports nothing of the JAX package.
"""Carmen log reader.

Host-side port of ``src/my_lidar_graph_slam/io/carmen/carmen_reader.cpp``:
parses PARAM, ODOM, FLASER/RLASER (old format), RAWLASER1-4 and
ROBOTLASER1-2 (new format) records into the sensor-data stream.  Field
layouts and defaults (angle increment guesses, Laser.* parameter fallbacks)
follow the reference (carmen_reader.cpp:160-500).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core import pose as P
from ..sensor.data import OdometryData, ScanData

_OLD_LASER_IDS = {"FLASER", "RLASER"}
_RAW_LASER_IDS = {"RAWLASER1", "RAWLASER2", "RAWLASER3", "RAWLASER4"}
_ROBOT_LASER_IDS = {"ROBOTLASER1", "ROBOTLASER2"}


def write_carmen_log(scans: List[ScanData], path: str) -> None:
    """Write ScanData records as an old-format (FLASER) Carmen log.

    The FLASER record layout is the one both this reader and the
    reference's ``CarmenLogReader::ReadOldLaserData``
    (carmen_reader.cpp:320-397) parse identically:

        FLASER n r1..rn laser_x laser_y laser_theta
               robot_x robot_y robot_theta ipc_ts host logger_ts

    Laser geometry rides on PARAM lines (``Laser.MinRange`` etc.), exactly
    the fallback chain the reference reads, so a synthetic sequence can be
    fed to the reference ``slam_launch`` binary for head-to-head runs.
    Requires uniformly spaced beam angles (true for all our generators).
    """
    if not scans:
        raise ValueError("no scans to write")
    first = scans[0]
    inc = float(first.angles[1] - first.angles[0]) if len(first.angles) > 1 \
        else _guess_angle_increment(len(first.angles))
    # The PARAM geometry is written once from scans[0]; a heterogeneous
    # sequence (e.g. post-ScanAccumulator) would silently mis-reconstruct
    # every later record, so enforce the docstring's uniformity contract.
    for i, s in enumerate(scans[1:], start=1):
        if (len(s.angles) != len(first.angles)
                or abs(float(s.angles[0]) - float(first.angles[0])) > 1e-9
                or s.min_range != first.min_range
                or s.max_range != first.max_range):
            raise ValueError(
                f"write_carmen_log requires uniform laser geometry: scan {i} "
                f"(n={len(s.angles)}, min_angle={float(s.angles[0]):.6f}, "
                f"range=[{s.min_range}, {s.max_range}]) differs from scan 0 "
                f"(n={len(first.angles)}, "
                f"min_angle={float(first.angles[0]):.6f}, "
                f"range=[{first.min_range}, {first.max_range}])")
    with open(path, "w") as f:
        f.write("# synthetic log exported by my_lidar_graph_slam_v2_tpu\n")
        f.write(f"PARAM Laser.MinRange {first.min_range:.6f}\n")
        f.write(f"PARAM Laser.MaxRange {first.max_range:.6f}\n")
        f.write(f"PARAM Laser.AngleIncrement {inc:.12f}\n")
        f.write(f"PARAM Laser.MinAngle {float(first.angles[0]):.12f}\n")
        f.write(
            f"PARAM Laser.MaxAngle "
            f"{float(first.angles[0]) + inc * len(first.angles):.12f}\n")
        for scan in scans:
            robot = np.asarray(scan.odom_pose, np.float64)
            laser = P.compound(robot, scan.relative_sensor_pose)
            parts = ["FLASER", str(len(scan.ranges))]
            parts += [f"{r:.6f}" for r in np.asarray(scan.ranges)]
            parts += [f"{v:.9f}" for v in laser]
            parts += [f"{v:.9f}" for v in robot]
            parts += [f"{scan.time_stamp:.6f}", "synth",
                      f"{scan.time_stamp:.6f}"]
            f.write(" ".join(parts) + "\n")


def _guess_angle_range(n: int) -> float:
    # carmen_reader.cpp:466-487
    if n == 181:
        return np.pi
    if n == 180:
        return np.pi * 179.0 / 180.0
    if n == 361:
        return np.pi
    if n == 360:
        return np.pi * 359.0 / 360.0
    if n == 401:
        return np.pi * 100.0 / 180.0
    if n == 400:
        return np.pi * 99.75 / 180.0
    return np.pi


def _guess_angle_increment(n: int) -> float:
    return _guess_angle_range(n) / max(n - 1, 1)


def read_carmen_log(path: str, native: Optional[bool] = None) -> List[object]:
    """Returns the time-ordered list of OdometryData / ScanData records.

    ``native=True`` parses with the C++ parser (``native/
    carmen_reader.cpp``, built with g++ at first use; it raises if it
    cannot be built); False and None (the default) both mean the Python
    reader.  The JAX reader's silent "try native, fall back" is not
    copied."""
    if native:
        return _read_native(path)
    return _read_python(path)


def _read_native(path: str) -> List[object]:
    from ..native import carmen_load_arrays

    odom, meta, all_ranges = carmen_load_arrays(path)
    records: List[tuple] = []
    for row in odom:
        records.append((
            row[0],
            OdometryData("ODOM", row[1], row[2:5].copy(),
                         np.array([row[5], 0.0, row[6]])),
        ))
    for row in meta:
        n = int(row[14])
        off = int(row[15])
        angles = row[12] + row[13] * np.arange(n)
        records.append((
            row[0],
            ScanData(
                "LASER", row[1], row[2:5].copy(), np.zeros(3),
                row[5:8].copy(), row[8], row[9], row[10], row[11],
                angles, all_ranges[off : off + n].copy(),
            ),
        ))
    records.sort(key=lambda r: r[0])
    return [r[1] for r in records]


def _read_python(path: str) -> List[object]:
    params: Dict[str, str] = {}
    out: List[object] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            tag = toks[0]
            try:
                if tag == "PARAM" and len(toks) >= 3:
                    params[toks[1]] = toks[2]
                elif tag == "ODOM":
                    out.append(_parse_odom(tag, toks[1:]))
                elif tag in _OLD_LASER_IDS:
                    rec = _parse_old_laser(tag, toks[1:], params)
                    if rec is not None:
                        out.append(rec)
                elif tag in _RAW_LASER_IDS:
                    rec = _parse_raw_laser(tag, toks[1:], robot=False)
                    if rec is not None:
                        out.append(rec)
                elif tag in _ROBOT_LASER_IDS:
                    rec = _parse_raw_laser(tag, toks[1:], robot=True)
                    if rec is not None:
                        out.append(rec)
            except (ValueError, IndexError):
                continue  # malformed line: skip, like the reference's
                # best-effort stream extraction
    return out


def _parse_odom(tag, t) -> OdometryData:
    x, y, th = float(t[0]), float(t[1]), float(t[2])
    tv, rv = float(t[3]), float(t[4])
    ts = float(t[6])
    return OdometryData(tag, ts, np.array([x, y, th]),
                        np.array([tv, 0.0, rv]))


def _parse_old_laser(tag, t, params) -> Optional[ScanData]:
    n = int(t[0])
    if n <= 0 or len(t) < n + 7:
        return None
    ranges = np.array([float(v) for v in t[1 : n + 1]])
    lx, ly, lth = (float(v) for v in t[n + 1 : n + 4])
    rx, ry, rth = (float(v) for v in t[n + 4 : n + 7])
    ts = float(t[n + 7]) if len(t) > n + 7 else 0.0
    laser_pose = np.array([lx, ly, lth])
    robot_pose = np.array([rx, ry, rth])

    min_range = float(params.get("Laser.MinRange", 0.0) or 0.0)
    max_range = float(params.get("Laser.MaxRange", 80.0) or 80.0)
    if "Laser.AngleIncrement" in params:
        inc = float(params["Laser.AngleIncrement"])
    else:
        inc = _guess_angle_increment(n)
    min_angle = float(params.get("Laser.MinAngle", -np.pi / 2))
    if "Laser.MaxAngle" in params:
        max_angle = float(params["Laser.MaxAngle"])
    elif "Laser.AngleIncrement" in params:
        max_angle = min_angle + inc * n
    else:
        max_angle = min_angle + _guess_angle_range(n)
    angles = min_angle + inc * np.arange(n)
    return ScanData(
        tag, ts, robot_pose, np.zeros(3),
        P.inverse_compound(robot_pose, laser_pose),
        min_range, max_range, min_angle, max_angle, angles, ranges,
    )


def _parse_raw_laser(tag, t, robot: bool) -> Optional[ScanData]:
    # laser_type start_angle fov angular_res max_range accuracy remission
    start_angle = float(t[1])
    angular_res = float(t[3])
    max_range = float(t[4])
    n = int(t[7])
    if n <= 0 or len(t) < 8 + n:
        return None
    ranges = np.array([float(v) for v in t[8 : 8 + n]])
    pos = 8 + n
    num_rem = int(t[pos])
    pos += 1 + num_rem
    robot_pose = np.zeros(3)
    rel_sensor = np.zeros(3)
    if robot:
        lx, ly, lth = (float(v) for v in t[pos : pos + 3])
        rx, ry, rth = (float(v) for v in t[pos + 3 : pos + 6])
        robot_pose = np.array([rx, ry, rth])
        rel_sensor = P.inverse_compound(robot_pose, np.array([lx, ly, lth]))
        pos += 6 + 2 + 3  # laser velocity (2) + safety dists/turn axis (3)
    ts = float(t[pos]) if len(t) > pos else 0.0
    angles = start_angle + angular_res * np.arange(n)
    max_angle = start_angle + angular_res * (n - 1)
    return ScanData(
        tag, ts, robot_pose, np.zeros(3), rel_sensor,
        0.0, max_range, start_angle, max_angle, angles, ranges,
    )
