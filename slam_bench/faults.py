"""Faults planted under the timed path, to show that the check fails
them.  Each takes the SLAM facade a configuration built and breaks one
layer by wrapping a method; nothing else changes."""
from __future__ import annotations

import functools

import numpy as np

from .record import wrap


def lm_unchanged(slam):
    """The optimiser hands back the poses it was given."""
    def make(orig):
        def call(map_poses, scan_poses, edges):
            _, _, stats = orig(map_poses, scan_poses, edges)
            return (np.array(map_poses, np.float32).astype(np.float64),
                    np.array(scan_poses, np.float32).astype(np.float64), stats)
        return call
    wrap(slam.backend.optimizer, "optimize", make)


def match_altered(slam, dx=0.05, every=1):
    """Every ``every``-th frontend match comes back ``dx`` metres off in x."""
    count = [0]

    def make(orig):
        def call(*a, **k):
            res = orig(*a, **k)
            count[0] += 1
            if count[0] % every == 0:
                res.estimated_pose = res.estimated_pose + np.array([dx, 0.0, 0.0])
            return res
        return call
    wrap(slam.frontend.scan_matcher, "optimize_pose_deltas", make)


def detect_half(slam):
    """Loop detection scores every second query of its batch and drops
    the rest."""
    def make(orig):
        def call(queries):
            return orig(queries[::2])
        return call
    wrap(slam.backend.loop_detector, "detect", make)


def loop_altered(slam, dx=0.05):
    """Every accepted loop edge's relative pose is ``dx`` metres off."""
    def make(orig):
        def call(queries):
            out = orig(queries)
            for r in out:
                r["relative_pose"] = r["relative_pose"] + np.array([dx, 0.0, 0.0])
            return out
        return call
    wrap(slam.backend.loop_detector, "detect", make)


def lm_skipped(slam, every=2):
    """Every ``every``-th backend step that accepted a loop edge skips its
    optimisation (the graph snapshot comes back empty)."""
    count = [0]

    def make(orig):
        def call():
            count[0] += 1
            return None if count[0] % every == 0 else orig()
        return call
    wrap(slam, "get_pose_graph_for_optimization", make)


def scan_dropped(slam, every=4):
    """Every ``every``-th keyframe's scan is left out of its local map."""
    count = [0]

    def make(orig):
        def call(pose_graph):
            count[0] += 1
            if count[0] % every == 0:
                return None
            return orig(pose_graph)
        return call
    wrap(slam.builder, "_update_grid_map", make)


FAULTS = dict(lm_unchanged=lm_unchanged, match_altered=match_altered,
              match_every4_altered=functools.partial(match_altered, every=4),
              detect_half=detect_half, loop_altered=loop_altered,
              lm_skipped=lm_skipped,
              scan_dropped=scan_dropped)
