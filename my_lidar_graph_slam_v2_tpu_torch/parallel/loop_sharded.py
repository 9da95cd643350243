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

:class:`LoopDetectorShardedBranchBound` runs branch-and-bound the same
way: the step's candidates as one batch per device, on the same staging.

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
from ..matching.branch_bound import (
    ROUND_BLOCKS,
    BranchBoundBatch,
    descend,
    pyramid_of,
)
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


class _BatchedLoopDetector:
    """What the batched detectors share: the devices (one, or a mesh: a
    tuple or list of devices), the map cache, the staging of a step's
    queries on a device, their split over the mesh and :meth:`detect`,
    which refines each found candidate with the final matcher on the
    mesh's first device, like the reference's final scan matcher."""

    def __init__(self, cfg, scan_matcher_cfg, final_scan_matcher, device,
                 resolution: float = 0.05, map_cache=None):
        self.cfg = cfg
        self.mcfg = scan_matcher_cfg
        self.final = final_scan_matcher
        self.mesh = (tuple(torch.device(d) for d in device)
                     if isinstance(device, (tuple, list))
                     else (torch.device(device),))
        self.device = self.mesh[0]
        self.resolution = resolution
        self.map_cache = map_cache or DeviceMapCache(resolution)

    def _stage(self, device, queries):
        """The step's distinct rasters (map cache), each query's slot
        among them, and the queries' beams, sensor poses and map offsets
        uploaded to ``device`` (no sync)."""
        slots, rasters = {}, []
        for q in queries:
            lm = q["local_map"]
            if lm.local_map_id not in slots:
                slots[lm.local_map_id] = len(rasters)
                rasters.append(self.map_cache.raster(lm))
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
        return dict(index=index, rasters=rasters, arrays=arrays,
                    beams=(ranges, angles, mask),
                    poses=to_device(poses, device, np.float32),
                    offsets=to_device(offsets, device, np.float32))

    def _chunks(self, queries):
        """The queries in contiguous chunks, one per mesh device."""
        return [(dev, [queries[i] for i in c]) for dev, c in zip(
            self.mesh, np.array_split(np.arange(len(queries)),
                                      len(self.mesh))) if len(c)]

    def _thresholds(self):
        return (float(np.float32(self.cfg.score_threshold)),
                float(np.float32(self.cfg.known_rate_threshold)))

    def _arrays_here(self, run, j, query):
        """Query ``j`` of a staged ``run``'s scan arrays on the first
        device, where the final matcher runs."""
        arrays = run["arrays"][j]
        if arrays.ranges.device != self.device:
            arrays = scan_to_arrays(query["query_node"].scan_data,
                                    self.cfg.beam_capacity, self.device)
        return arrays

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


class LoopDetectorShardedCorrelative(_BatchedLoopDetector):
    """Drop-in loop detector running all candidates as one batch per
    device of ``device``, a device or a mesh (a tuple or list of devices);
    the same matcher core as ``LoopDetectorCorrelative``.

    A step makes one host fetch, and one more per candidate re-run
    densely, which the registry counter ``LoopDetector.DenseReruns``
    counts; the final matcher makes its own."""

    def __init__(self, cfg, scan_matcher_cfg: CorrelativeConfig,
                 final_scan_matcher, device, resolution: float = 0.05,
                 map_cache=None):
        super().__init__(cfg, scan_matcher_cfg, final_scan_matcher, device,
                         resolution, map_cache)
        self._fn = make_batched_loop_csm(scan_matcher_cfg)
        self._m_dense_reruns = MetricManager.instance().counter(
            "LoopDetector.DenseReruns")

    def _launch(self, device, queries):
        """Stage ``queries`` on ``device`` and launch their batch (no
        sync); returns what the host fetch and the re-runs read."""
        run = self._stage(device, queries)
        rasters = run["rasters"]
        coarse = [coarse_of(r, self.mcfg.low_resolution) for r in rasters]
        run["maps"] = [torch.stack(m).to(device) for m in (
            [r.prob for r in rasters], [r.observed for r in rasters],
            [c[0] for c in coarse], [c[1] for c in coarse])]
        run["out"] = self._fn(*run["maps"], *run["beams"], run["poses"],
                              run["offsets"], *self._thresholds(),
                              to_device(run["index"], device, np.int64))
        return run

    def match(self, queries):
        """The batched core over ``queries`` in contiguous chunks, one per
        mesh device, one host fetch for all, then a dense re-run of each
        candidate whose argmax a prune could not certify.  Returns, per
        query in order, (raster, scan arrays, sensor pose, score, found);
        an empty list launches nothing."""
        if not queries:
            return []
        span = MetricManager.instance().span
        with span("match.search"):
            runs = [self._launch(dev, qs) for dev, qs in self._chunks(queries)]
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
                matched.append((r["rasters"][slot],
                                self._arrays_here(r, j, queries[i]),
                                best_pose[i], float(score[i]),
                                bool(found[i])))
        return matched


class LoopDetectorShardedBranchBound(_BatchedLoopDetector):
    """Drop-in loop detector running branch-and-bound
    (``matching/branch_bound.py``, the reference's
    ``LoopDetectorBranchBound``) over all of a backend step's candidates
    as one :class:`BranchBoundBatch` per device of ``device``, a device or
    a mesh: one hit-image build and one bound sweep for each, one fetch of
    all their bounds, then lockstep rounds of at most ``ROUND_BLOCKS``
    blocks a candidate, one fetch each (:func:`descend`: spans
    ``bb.bound``, ``bb.descend``, ``bb.round`` and the counters
    ``LoopDetector.BranchBound.*``).  Each map's pyramid is cached on its
    map-cache entry, as ``ScanMatcherBranchBound.pyramid_of`` caches it.
    The winners, scores and gates are the serial matcher's, bit for bit."""

    def _start(self, device, queries):
        """Stage ``queries`` on ``device`` and launch their batch's bounds
        (no sync)."""
        run = self._stage(device, queries)
        pyr = [pyramid_of(r, self.mcfg.bound_height) for r in run["rasters"]]
        maps = [torch.stack(m).to(device) for m in (
            [r.prob for r in run["rasters"]],
            [r.observed for r in run["rasters"]],
            [p[0] for p in pyr], [p[1] for p in pyr])]
        run["batch"] = BranchBoundBatch(
            self.mcfg, *maps, *run["beams"], run["poses"], run["offsets"],
            *self._thresholds(),
            map_index=to_device(run["index"], device, np.int64))
        return run

    def match(self, queries):
        """Branch-and-bound over ``queries``, in contiguous chunks, one
        per mesh device, run in lockstep.  Returns, per query in order,
        (raster, scan arrays, sensor pose, score, found); an empty list
        launches nothing."""
        if not queries:
            return []
        runs = []

        def start():
            runs.extend(self._start(dev, qs)
                        for dev, qs in self._chunks(queries))
            return [r["batch"] for r in runs]

        with MetricManager.instance().span("match.search"):
            results = descend(start, self.device, ROUND_BLOCKS)
        matched = []
        for r, (pose, score, found, _) in zip(runs, results):
            for j, slot in enumerate(r["index"]):
                matched.append((r["rasters"][slot],
                                self._arrays_here(r, j, queries[len(matched)]),
                                pose[j].astype(np.float64), float(score[j]),
                                bool(found[j])))
        return matched
