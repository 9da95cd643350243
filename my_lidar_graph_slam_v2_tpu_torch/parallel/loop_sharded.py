"""Batched loop detection: all of a backend step's candidates in one
batch per device.

Port of ``my_lidar_graph_slam_v2_tpu/parallel/loop_sharded.py``.  On one
device (the JAX package's one-device mesh: one ``vmap`` of the correlative
core, one dispatch and one fetch per step) the batch is
:func:`correlative_core_batch`: one coarse and one fine CSM sweep launch
for every candidate of the step, one host fetch of the results.  On a mesh
(``parallel/mesh.py``) the step's candidates are split into contiguous
chunks, one per device, each chunk one such batch on its device: the
single-process counterpart of the JAX package's ``shard_map`` fan-out.
The results come back in query order, in one fetch.

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
from ..loop.detector import scan_arrays_batch, scan_to_arrays
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
    """Drop-in loop detector running all candidates as one batch per
    device of ``device``, a device or a mesh (a tuple or list of devices);
    the same matcher core as ``LoopDetectorCorrelative``.  The final GN
    refinement runs per found candidate afterwards, on the mesh's first
    device, like the reference's final scan matcher.

    A step makes one host fetch, and one more per candidate re-run
    densely, which the registry counter ``LoopDetector.DenseReruns``
    counts; the final matcher makes its own."""

    def __init__(self, cfg, scan_matcher_cfg: CorrelativeConfig,
                 final_scan_matcher, device, resolution: float = 0.05,
                 map_cache=None):
        self.cfg = cfg
        self.mcfg = scan_matcher_cfg
        self.final = final_scan_matcher
        self.mesh = (tuple(torch.device(d) for d in device)
                     if isinstance(device, (tuple, list))
                     else (torch.device(device),))
        self.device = self.mesh[0]
        self.resolution = resolution
        self.map_cache = map_cache or DeviceMapCache(resolution)
        self._fn = make_batched_loop_csm(scan_matcher_cfg)
        self._m_dense_reruns = MetricManager.instance().counter(
            "LoopDetector.DenseReruns")

    def _launch(self, device, queries):
        """Stage ``queries`` on ``device`` and launch their batch (no
        sync); returns what the host fetch and the re-runs read."""
        slots, rasters = {}, []
        for q in queries:
            lm = q["local_map"]
            if lm.local_map_id not in slots:
                slots[lm.local_map_id] = len(rasters)
                rasters.append(self.map_cache.raster(lm))
        coarse = [coarse_of(r, self.mcfg.low_resolution) for r in rasters]
        maps = [torch.stack(m).to(device) for m in (
            [r.prob for r in rasters], [r.observed for r in rasters],
            [c[0] for c in coarse], [c[1] for c in coarse])]

        (ranges, angles, mask), arrays = scan_arrays_batch(
            [q["query_node"].scan_data for q in queries],
            self.cfg.beam_capacity, device)
        index = [slots[q["local_map"].local_map_id] for q in queries]
        poses = np.stack([
            P.compound(P.inverse_compound(q["local_map_node"].global_pose,
                                          q["query_node"].global_pose),
                       a.rel_sensor_pose)
            for q, a in zip(queries, arrays)])
        offsets = np.stack([rasters[i].offset_xy for i in index])
        poses_d = to_device(poses, device, np.float32)
        offsets_d = to_device(offsets, device, np.float32)
        out = self._fn(*maps, ranges, angles, mask, poses_d, offsets_d,
                       *self._thresholds(), to_device(index, device, np.int64))
        return dict(out=out, maps=maps, index=index, rasters=rasters,
                    arrays=arrays, beams=(ranges, angles, mask),
                    poses=poses_d, offsets=offsets_d)

    def _thresholds(self):
        return (float(np.float32(self.cfg.score_threshold)),
                float(np.float32(self.cfg.known_rate_threshold)))

    def match(self, queries):
        """The batched core over ``queries`` in contiguous chunks, one per
        mesh device, one host fetch for all, then a dense re-run of each
        candidate whose argmax a prune could not certify.  Returns, per
        query in order, (raster, scan arrays, sensor pose, score, found);
        an empty list launches nothing."""
        if not queries:
            return []
        chunks = [c for c in np.array_split(np.arange(len(queries)),
                                            len(self.mesh)) if len(c)]
        span = MetricManager.instance().span
        with span("match.search"):
            runs = [self._launch(dev, [queries[i] for i in c])
                    for dev, c in zip(self.mesh, chunks)]
        # One device-to-host fetch for the whole step, of what the host
        # reads: pose, score, found and exact.
        fields = [[r["out"][k] for r in runs] for k in (0, 1, 3, 6)]
        best_pose, score, found, exact = fetch(tuple(
            f[0] if len(f) == 1 else torch.cat([t.to(self.device) for t in f])
            for f in fields))

        matched = []
        for r in runs:
            ranges, angles, mask = r["beams"]
            for j, slot in enumerate(r["index"]):
                i = len(matched)
                if not exact[i]:
                    # A prune could not certify this candidate's argmax:
                    # redo it densely through the serial core.
                    with span("match.search"):
                        d = correlative_core(
                            self.mcfg, *(m[slot] for m in r["maps"]),
                            ranges[j], angles[j], mask[j], r["poses"][j],
                            r["offsets"][j], *self._thresholds(), dense=True,
                        )
                    d = fetch(d)
                    self._m_dense_reruns.increment()
                    best_pose[i], score[i], found[i] = d[0], d[1], d[3]
                arrays = r["arrays"][j]
                if arrays.ranges.device != self.device:
                    arrays = scan_to_arrays(queries[i]["query_node"].scan_data,
                                            self.cfg.beam_capacity,
                                            self.device)
                matched.append((r["rasters"][slot], arrays, best_pose[i],
                                float(score[i]), bool(found[i])))
        return matched

    def detect(self, queries) -> List[dict]:
        results = []
        for q, (raster, arrays, pose, score, found) in zip(
                queries, self.match(queries)):
            if not found:
                continue
            est_robot = P.move_backward(pose, arrays.rel_sensor_pose)
            final = self.final.optimize_pose(
                ScanMatchingQuery(raster, arrays, est_robot))
            results.append(dict(
                relative_pose=final.estimated_pose,
                local_map_id=q["local_map"].local_map_id,
                scan_node_id=q["query_node"].node_id,
                covariance=final.covariance,
                score=score,
            ))
        return results
