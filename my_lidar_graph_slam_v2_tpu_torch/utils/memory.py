# The port's own copies of physical_memory_usage and peak_memory_usage from
# my_lidar_graph_slam_v2_tpu/utils/memory.py, logic unchanged.
"""Process memory introspection.

Equivalent of ``src/my_lidar_graph_slam/memory_usage.cpp:12-40`` (parsing
/proc/self/status VmRSS and VmHWM for the metric subsystem).
"""
from __future__ import annotations


def physical_memory_usage() -> int:
    """Current resident set size in bytes (VmRSS)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0



def peak_memory_usage() -> int:
    """Peak resident set size in bytes (VmHWM)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
