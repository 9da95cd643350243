"""Batched loop detection: all of a backend step's candidates in one
batch on one GPU.

Port of ``my_lidar_graph_slam_v2_tpu/parallel/loop_sharded.py`` on one
device (the JAX package's one-device mesh: one ``vmap`` of the
correlative core, one dispatch and one fetch per step).  Here the batch is
:func:`correlative_core_batch`: one coarse and one fine CSM sweep launch
for every candidate of the step, one host fetch of the results.  A
fan-out over several GPUs is ROADMAP item 1.16.

The candidate count is not padded: the JAX package pads it to
power-of-two buckets only to bound XLA recompiles, and eager PyTorch
compiles nothing per shape.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core import pose as P
from ..grid.map_cache import DeviceMapCache
from ..loop.detector import scan_arrays_batch
from ..matching.correlative import (
    CorrelativeConfig,
    coarse_of,
    correlative_core,
    correlative_core_batch,
)
from ..matching.types import ScanMatchingQuery
from ..metrics.registry import MetricManager
from ..utils.transfer import fetch, to_device


def make_batched_loop_csm(cfg: CorrelativeConfig):
    """fn(prob, observed, coarse_prob, coarse_observed, ranges, angles,
    mask, sensor_pose, offset_xy, score_thr, known_thr, map_index) -> the
    JAX batch's 7-tuple per candidate (pose, score, known, found, cost / n,
    covariance, exact), on the inputs' device: the node-accounting tail is
    dropped, the ``exact`` flag kept for the dense re-runs."""

    def batched(prob, observed, coarse_prob, coarse_observed, ranges, angles,
                mask, sensor_pose, offset_xy, score_thr, known_thr, map_index):
        out = correlative_core_batch(
            cfg, prob, observed, coarse_prob, coarse_observed, ranges, angles,
            mask, sensor_pose, offset_xy, score_thr, known_thr,
            map_index=map_index,
        )
        return out[:6] + (out[8],)

    return batched


class LoopDetectorShardedCorrelative:
    """Drop-in loop detector running all candidates as one batch on
    ``device``; the same matcher core as ``LoopDetectorCorrelative``.  The
    final GN refinement runs per found candidate afterwards, like the
    reference's final scan matcher.

    ``host_fetches`` counts device-to-host transfers (one per step, one
    more per dense re-run; the final matcher counts its own) and
    ``dense_reruns`` the candidates re-run densely."""

    def __init__(self, cfg, scan_matcher_cfg: CorrelativeConfig,
                 final_scan_matcher, device, resolution: float = 0.05,
                 map_cache=None):
        self.cfg = cfg
        self.mcfg = scan_matcher_cfg
        self.final = final_scan_matcher
        self.device = torch.device(device)
        self.resolution = resolution
        self.map_cache = map_cache or DeviceMapCache(resolution)
        self._fn = make_batched_loop_csm(scan_matcher_cfg)
        self.host_fetches = 0
        self.dense_reruns = 0
        # Bytes staged per detect() for the step's map stack: the distinct
        # rasters' u8 prob and bool observed plus their coarse pair
        # (M * h * w * 4 for M distinct maps).  The JAX package stages
        # C * h * w * 2 for the C padded candidates and pools inside its
        # jit, so the port stages less whenever the candidates fall in
        # fewer than C / 2 maps.
        self._m_stack_bytes = MetricManager.instance().value_sequence(
            "LoopDetector.MapStackBytes"
        )

    def detect(self, queries) -> List[dict]:
        if not queries:
            return []
        slots, rasters = {}, []
        for q in queries:
            lm = q["local_map"]
            if lm.local_map_id not in slots:
                slots[lm.local_map_id] = len(rasters)
                rasters.append(self.map_cache.raster(lm))
        coarse = [coarse_of(r, self.mcfg.low_resolution) for r in rasters]
        maps = [torch.stack(m) for m in (
            [r.prob for r in rasters], [r.observed for r in rasters],
            [c[0] for c in coarse], [c[1] for c in coarse])]
        self._m_stack_bytes.observe(sum(m.numel() * m.element_size()
                                        for m in maps))

        (ranges, angles, mask), arrays = scan_arrays_batch(
            [q["query_node"].scan_data for q in queries],
            self.cfg.beam_capacity, self.device)
        index = [slots[q["local_map"].local_map_id] for q in queries]
        poses = np.stack([
            P.compound(P.inverse_compound(q["local_map_node"].global_pose,
                                          q["query_node"].global_pose),
                       a.rel_sensor_pose)
            for q, a in zip(queries, arrays)])
        offsets = np.stack([rasters[i].offset_xy for i in index])
        poses_d = to_device(poses, self.device, np.float32)
        offsets_d = to_device(offsets, self.device, np.float32)
        thresholds = (float(np.float32(self.cfg.score_threshold)),
                      float(np.float32(self.cfg.known_rate_threshold)))
        out = self._fn(*maps, ranges, angles, mask, poses_d, offsets_d,
                       *thresholds, to_device(index, self.device, np.int64))
        # One device-to-host fetch for the whole batch, of what the host
        # reads: pose, score, found and exact.
        best_pose, score, found, exact = fetch(
            (out[0], out[1], out[3], out[6]))
        self.host_fetches += 1

        results = []
        for i, q in enumerate(queries):
            raster = rasters[index[i]]
            if not exact[i]:
                # A prune could not certify this candidate's argmax: redo
                # it densely through the serial core, replacing its row.
                d = fetch(correlative_core(
                    self.mcfg, raster.prob, raster.observed, *coarse[index[i]],
                    ranges[i], angles[i], mask[i], poses_d[i], offsets_d[i],
                    *thresholds, dense=True,
                ))
                self.host_fetches += 1
                self.dense_reruns += 1
                best_pose[i], score[i], found[i] = d[0], d[1], d[3]
            if not found[i]:
                continue
            est_robot = P.move_backward(best_pose[i], arrays[i].rel_sensor_pose)
            final = self.final.optimize_pose(
                ScanMatchingQuery(raster, arrays[i], est_robot))
            results.append(dict(
                relative_pose=final.estimated_pose,
                local_map_id=q["local_map"].local_map_id,
                scan_node_id=q["query_node"].node_id,
                covariance=final.covariance,
                score=float(score[i]),
            ))
        return results
