"""Loop-candidate searchers of the port.

The JAX package's ``loop/searcher.py`` works on the pose graph with NumPy
alone (it imports no JAX and touches no device), so the port uses it as
is; a backend built with the port imports its searcher from here.
"""
from my_lidar_graph_slam_v2_tpu.loop.searcher import (  # noqa: F401
    LoopSearcherConfig,
    LoopSearcherNearest,
)

__all__ = ["LoopSearcherConfig", "LoopSearcherNearest"]
