"""What the correctness check reads from a run: the program's outputs at
each layer, taken by wrapping methods of the objects the configuration
built (no file of the program changes).

Per pose-graph node the raw scan it came from, its local map, and its
pose and its map's pose when it was appended; per local map its pose and
the poses of the nodes before it when it was started; per frontend match
(either of the matcher's entries) the latest-map window's node poses and
the matched pose; per loop-detection
call each query's map and node with their poses, and the edges accepted
(map, node, relative pose); per optimisation the graph handed in and the
poses handed back; per backend step whether it ran detection.  Host copies
of a few poses per keyframe; nothing touches the device.
"""
from __future__ import annotations

import numpy as np


def wrap(obj, name, make):
    """Replace ``obj.name`` with ``make(original)``."""
    setattr(obj, name, make(getattr(obj, name)))


class Recorder:
    def __init__(self, slam, latest_window: int, overlapped: int):
        self.node_raw = []   # node id -> raw scan index
        self.nodes = []      # node id -> (map id, pose, map pose) at append
        self.maps = {}       # map id -> pose and the nodes before it
        self.matches, self.loops, self.lm = [], [], []
        self.detects = []    # per detect call: queries and accepted edges
        self.steps = []      # per backend step: whether it was in the window
        self.current_raw = None
        self.in_window = False
        self._install(slam, latest_window, overlapped)

    def _install(self, slam, n_latest, n_overlap):
        pg, b = slam.pose_graph, slam.builder

        def appender(orig):
            def call(pose, cov_or_scan, *rest):
                self.node_raw.append(self.current_raw)
                out = orig(pose, cov_or_scan, *rest)
                nd = pg.scan_nodes[-1]
                self.nodes.append((
                    nd.local_map_id, nd.global_pose.copy(),
                    pg.local_map_nodes[nd.local_map_id].global_pose.copy()))
                return out
            return call

        wrap(slam, "append_first_node_and_edge", appender)
        wrap(slam, "append_node_and_edge", appender)

        def new_map(orig):
            def call(pose_graph, scan_pose, scan_pose_cov, scan_node_id):
                k = len(b.local_maps)
                self.maps[k] = dict(
                    pose=np.array(scan_pose, np.float64),
                    before=[(nd.node_id, nd.global_pose.copy())
                            for nd in pose_graph.scan_nodes[-n_overlap:]],
                    in_window=self.in_window)
                return orig(pose_graph, scan_pose, scan_pose_cov,
                            scan_node_id)
            return call

        wrap(b, "_append_local_map", new_map)

        matcher = slam.frontend.scan_matcher

        def match(path):
            def make(orig):
                def call(*a, **k):
                    res = orig(*a, **k)
                    self.matches.append(dict(
                        raw=self.current_raw, path=path,
                        window=[(nd.node_id, nd.global_pose.copy())
                                for nd in pg.scan_nodes[-n_latest:]],
                        est=np.array(res.estimated_pose, np.float64),
                        found=bool(res.pose_found), in_window=self.in_window))
                    return res
                return call
            return make

        for path in ("optimize_pose_deltas", "optimize_pose"):
            if hasattr(matcher, path):
                wrap(matcher, path, match(path))
        if slam.backend is None:
            return

        def step(orig):
            def call(parent):
                self.steps.append(self.in_window)
                return orig(parent)
            return call

        def detect(orig):
            def call(queries):
                asked = [dict(
                    map_id=int(q["local_map"].local_map_id),
                    node_id=int(q["query_node"].node_id),
                    map_pose=np.array(q["local_map_node"].global_pose,
                                      np.float64),
                    node_pose=np.array(q["query_node"].global_pose,
                                       np.float64)) for q in queries]
                results = orig(queries)
                edges = [dict(
                    map_id=int(r["local_map_id"]), node_id=int(r["scan_node_id"]),
                    rel=np.array(r["relative_pose"], np.float64),
                    in_window=self.in_window) for r in results]
                self.loops.extend(edges)
                self.detects.append(dict(queries=asked, edges=edges,
                                         in_window=self.in_window))
                return results
            return call

        def optimize(orig):
            def call(map_poses, scan_poses, edges):
                mp, sp, stats = orig(map_poses, scan_poses, edges)
                self.lm.append(dict(
                    map_poses=map_poses, scan_poses=scan_poses, edges=edges,
                    out_map=np.array(mp, np.float64),
                    out_scan=np.array(sp, np.float64),
                    in_window=self.in_window))
                return mp, sp, stats
            return call

        wrap(slam.backend, "run_step", step)
        wrap(slam.backend.loop_detector, "detect", detect)
        wrap(slam.backend.optimizer, "optimize", optimize)
