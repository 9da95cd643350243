# The port's own copy of my_lidar_graph_slam_v2_tpu/loop/searcher.py, logic
# unchanged: the port imports nothing of the JAX package.
"""Loop candidate search (nearest-node strategy), vectorized.

Re-implements ``LoopSearcherNearest``
(``mapping/loop_searcher_nearest.cpp:59-170``): query nodes are the scans
of the last finished local map; reference nodes are scans of older
finished maps whose residual travel distance to the present exceeds
``travel_dist_threshold``; among (ref, query) pairs closer than
``node_dist_threshold`` the ``num_candidate_nodes`` nearest are returned.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass(frozen=True)
class LoopSearcherConfig:
    travel_dist_threshold: float = 10.0
    node_dist_threshold: float = 5.0
    num_candidate_nodes: int = 2


class LoopSearcherNearest:
    def __init__(self, cfg: LoopSearcherConfig = LoopSearcherConfig()):
        from ..metrics.registry import MetricManager

        self.cfg = cfg
        # Reference series (loop_searcher_nearest.cpp:14-27); NodeDist is
        # observed once per returned candidate, as squared distance
        vs = MetricManager.instance().value_sequence
        self._m_accum = vs("LoopSearcherNearest.AccumTravelDist")
        self._m_node_dist = vs("LoopSearcherNearest.NodeDist")
        self._m_num_candidates = vs("LoopSearcherNearest.NumOfCandidateNodes")

    def search(self, hint) -> List[dict]:
        if hint is None:
            return []
        scan_poses = hint["scan_poses"]
        map_ranges = hint["map_ranges"]
        accum = hint["accum_travel_dist"]
        last_id = hint["last_finished_map_id"]

        query_range = next(r for r in map_ranges if r[0] == last_id)
        q_ids = np.arange(query_range[1], query_range[2] + 1)
        q_pos = scan_poses[q_ids, :2]

        # Reference nodes: maps strictly older than the query map, walked in
        # order while the residual travel distance stays above threshold.
        ref_ids = []
        node_travel = 0.0
        prev = None
        stop = False
        for mid, lo, hi in map_ranges:
            if mid >= last_id or stop:
                break
            for nid in range(lo, hi + 1):
                p = scan_poses[nid, :2]
                if prev is not None:
                    node_travel += float(np.hypot(*(p - prev)))
                prev = p
                if accum - node_travel < self.cfg.travel_dist_threshold:
                    stop = True
                    break
                ref_ids.append(nid)
        self._m_accum.observe(float(accum))
        if not ref_ids:
            self._m_num_candidates.observe(0)
            return []
        ref_ids = np.asarray(ref_ids)
        r_pos = scan_poses[ref_ids, :2]

        d2 = ((r_pos[:, None, :] - q_pos[None, :, :]) ** 2).sum(-1)  # [R, Q]
        thr2 = self.cfg.node_dist_threshold ** 2
        rr, qq = np.nonzero(d2 < thr2)
        if len(rr) == 0:
            self._m_num_candidates.observe(0)
            return []
        dists = d2[rr, qq]
        k = min(self.cfg.num_candidate_nodes, len(dists))
        sel = np.argpartition(dists, k - 1)[:k]

        # Map id per reference node
        map_of = np.zeros(scan_poses.shape[0], np.int64)
        for mid, lo, hi in map_ranges:
            map_of[lo : hi + 1] = mid

        out = []
        self._m_num_candidates.observe(len(sel))
        for s in sel:
            rid = int(ref_ids[rr[s]])
            qid = int(q_ids[qq[s]])
            self._m_node_dist.observe(float(dists[s]))
            out.append(
                dict(
                    query_node_id=qid,
                    ref_node_id=rid,
                    ref_map_id=int(map_of[rid]),
                )
            )
        return out
