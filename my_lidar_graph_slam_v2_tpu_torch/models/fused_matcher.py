"""Fused frontend matcher: latest-map fold, CSM window search and GN
refinement as one device sequence with one result fetch.

Port of ``my_lidar_graph_slam_v2_tpu/models/fused_matcher.py``
(``lidar_graph_slam_frontend.cpp:210-237``).  The JAX package compiles
the whole two-stage match into one jit; here it is one eager sequence of
device ops (on the card the two CSM sweeps are the sweep kernel and the
refinement with its covariance one launch of the Gauss-Newton kernel) whose
results come back to the host in a single transfer per keyframe — two
when a prune cannot certify the argmax and the dense sweep re-runs.

On the card each matcher captures the search (:func:`correlative_core`,
~800 small ops) once per input key as CUDA graphs around its two sweeps
and replays them on every later call (:class:`SearchGraphs`).
"""
from __future__ import annotations

import collections
import functools
import time

import numpy as np
import torch

from ..core import pose as P
from ..matching.correlative import (
    CorrelativeConfig,
    ScanMatcherCorrelative,
    correlative_core,
)
from ..matching.cost import COST_SQUARE_ERROR
from ..matching.linear_solver import LinearSolverConfig, LinearSolverMetrics
from ..matching.types import (
    ScanMatchingQuery,
    ScanMatchingSummary,
)
from ..metrics.registry import MetricManager
from ..ops import csm, gauss_newton, quant, rasterize
from ..utils.capture import collector_paused
from ..utils.transfer import fetch, to_device


class _Capture:
    """The steps of one capture of the search: CUDA graphs, and between
    them its sweeps, each recorded as a call of ``ops/csm.py:sweep`` with
    the graph-held arguments it takes and the buffer the next graph reads
    its result from."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.steps = []
        self.graph = None

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def end(self):
        graph, self.graph = self.graph, None
        if graph is not None:
            graph.capture_end()
            self.steps.append(graph.replay)

    def sweep(self, win, hr, hc, ok, origins, *, tile_h, tile_w, stride):
        """``sweep_fn`` of the captured search: ends the graph before the
        sweep and begins the next one after it; returns the buffer that
        the sweep's result is copied into at replay."""
        self.end()
        result = torch.empty(
            (win.shape[0], hr.shape[1], 2, origins.shape[1] * tile_h * tile_w),
            dtype=torch.float32, device=win.device)
        self.steps.append(functools.partial(
            _sweep_into, result, win, hr, hc, ok, origins,
            dict(tile_h=tile_h, tile_w=tile_w, stride=stride)))
        self.begin()
        return result


def _sweep_into(result, win, hr, hc, ok, origins, kw):
    result.copy_(csm.sweep(win, hr, hc, ok, origins, **kw))


class _SearchReplay:
    """:func:`correlative_core` at one key, captured: the tensors it reads
    (clones of its first call's inputs; None for absent coarse maps), its
    steps (:class:`_Capture`) and the tensors its last graph writes.  The
    sweeps are not captured: at replay each runs on the card through
    ``ops/csm.py:sweep`` as in an eager search, its launch counted by the
    kernel's wrapper and seen by whatever fences or times ``sweep``, and
    a capture, which launches no sweep, never calls it."""

    def __init__(self, steps, inputs, outputs):
        self.steps, self.inputs, self.outputs = steps, inputs, outputs

    @classmethod
    def capture(cls, ccfg, tensors, thresholds, dense):
        """Run the search eagerly on a side stream, then capture it there
        in thread-local mode with the garbage collector paused, as the
        LM's capture does.  Returns the eager run's outputs and the
        capture."""
        dev = tensors[0].device
        here = torch.cuda.current_stream(dev)
        inputs = [None if t is None else t.clone() for t in tensors]
        side = torch.cuda.Stream(dev)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            out = correlative_core(ccfg, *inputs, *thresholds, dense=dense)
            cap = _Capture()
            with collector_paused():
                cap.begin()
                try:
                    outputs = correlative_core(ccfg, *inputs, *thresholds,
                                               dense=dense,
                                               sweep_fn=cap.sweep)
                finally:
                    cap.end()
        here.wait_stream(side)
        for t in out:
            t.record_stream(here)
        return out, cls(cap.steps, inputs, outputs)

    def __call__(self, tensors):
        for dst, src in zip(self.inputs, tensors):
            if dst is not None:
                dst.copy_(src)
        for step in self.steps:
            step()
        return self.outputs


class SearchGraphs:
    """One matcher's search, called as :func:`correlative_core`: on the
    card one capture per key (:class:`_SearchReplay`), made at the key's
    first call, which returns its eager run's result, and replayed at
    every later one.  CPU tensors run eagerly, and so does a
    GreedyEndpoint cost, whose covariance uploads its steps from the host
    at each call, which a graph would not repeat.  The key is all that
    fixes the captured work: the config, ``dense``, the device, each
    input's dtype and shape (absent coarse maps too) and the two
    thresholds.  The newest ``KEPT`` keys are kept.  The registry counts
    the captures (``<name>.GraphCaptures``) and the calls that replay
    (``<name>.GraphReplays``), each in a span below the caller's.

    A replay returns the capture's own output tensors: they hold its
    result until the next call at the same key replays it again, so a
    caller fetches them before that, as the matcher does."""

    # A run meets about two keys a matcher: the pruned search and the
    # dense re-run
    KEPT = 4

    def __init__(self, name: str):
        self.name = name
        self._graphs = collections.OrderedDict()

    def _captures(self, ccfg: CorrelativeConfig, prob) -> bool:
        """Whether the search runs as a capture's replay."""
        return prob.device.type == "cuda" and (
            ccfg.cost is None or ccfg.cost.cost_type == COST_SQUARE_ERROR)

    def __call__(self, ccfg: CorrelativeConfig, prob, observed, coarse_p,
                 coarse_o, ranges, angles, mask, sensor_pose, offset_xy,
                 score_threshold, known_rate_threshold, *,
                 dense: bool = False):
        tensors = (prob, observed, coarse_p, coarse_o, ranges, angles, mask,
                   sensor_pose, offset_xy)
        thresholds = (score_threshold, known_rate_threshold)
        if not self._captures(ccfg, prob):
            return correlative_core(ccfg, *tensors, *thresholds, dense=dense)
        key = (ccfg, dense, prob.device,
               tuple(None if t is None else (t.dtype, tuple(t.shape))
                     for t in tensors),
               tuple(float(v) for v in thresholds))
        mm = MetricManager.instance()
        replay = self._graphs.pop(key, None)
        if replay is None:
            with mm.span("search.capture"):
                out, replay = _SearchReplay.capture(ccfg, tensors, thresholds,
                                                    dense)
            mm.counter(f"{self.name}.GraphCaptures").increment()
        else:
            with mm.span("search.replay"):
                out = replay(tensors)
            mm.counter(f"{self.name}.GraphReplays").increment()
        self._graphs[key] = replay
        while len(self._graphs) > self.KEPT:
            self._graphs.popitem(last=False)
        return out


def fused_body(ccfg: CorrelativeConfig, lcfg: LinearSolverConfig, prob,
               observed, coarse_p, coarse_o, ranges, angles, mask,
               sensor_pose, offset_xy, score_threshold, known_rate_threshold,
               *, dense: bool = False, search=correlative_core):
    """CSM search (``search``: :func:`correlative_core` or a matcher's
    :class:`SearchGraphs`) then GN refinement and covariance; returns the
    JAX ``_fused_body``'s 12-tuple as device tensors."""
    span = MetricManager.instance().span
    with span("match.search"):
        (csm_pose, score, known, found, csm_ncost, _, n_proc, n_total,
         exact) = search(
            ccfg, prob, observed, coarse_p, coarse_o, ranges, angles, mask,
            sensor_pose, offset_xy, score_threshold, known_rate_threshold,
            dense=dense,
        )
    with span("match.refine"):
        n = torch.clamp(mask.sum().to(torch.float32), min=1.0)
        refined, cost, iters, cov, _ = gauss_newton.refine(
            prob, observed, ranges, angles, mask, csm_pose, ccfg.resolution,
            offset_xy,
            max_iterations=lcfg.num_iterations_max,
            convergence_threshold=lcfg.convergence_threshold,
            initial_lambda=lcfg.initial_lambda,
            covariance_scale=lcfg.covariance_scale,
        )
    return (refined, cov, score, known, found, torch.div(cost, n), iters,
            n_proc, n_total, csm_pose, csm_ncost, exact)


def fused_core_deltas(ccfg: CorrelativeConfig, lcfg: LinearSolverConfig,
                      deltas, shifts, valid, ranges, angles, mask,
                      sensor_pose, offset_xy, score_threshold,
                      known_rate_threshold, *, max_shift: int,
                      dense: bool = False, search=correlative_core):
    """The whole frontend keyframe match (``_fused_core_deltas``):
    latest-map fold from per-scan deltas -> u8 quantize -> pool-on-crop
    -> coarse + fine CSM sweeps -> GN refinement -> covariance."""
    with MetricManager.instance().span("match.fold"):
        lo, obs = rasterize.fold_shifted_deltas(
            deltas, shifts, valid, max_shift=max_shift
        )
        prob = quant.quantize_prob(lo, obs)
    return fused_body(
        ccfg, lcfg, prob, obs, None, None, ranges, angles, mask,
        sensor_pose, offset_xy, score_threshold, known_rate_threshold,
        dense=dense, search=search,
    )


class FusedCorrelativeGNMatcher:
    """Drop-in two-stage matcher; ``fused = True`` tells the frontend to
    skip its separate final-matcher call."""

    fused = True
    supports_deltas = True

    def __init__(self, ccfg: CorrelativeConfig, lcfg: LinearSolverConfig,
                 device, name: str = "ScanMatcherCorrelativeFused",
                 final_name: str = None, final_time_fraction: float = 0.5):
        self.ccfg = ccfg
        self.lcfg = lcfg
        self.device = torch.device(device)
        self.name = name
        self._series = ScanMatcherCorrelative(ccfg, device, name)
        self.metrics = self._series.metrics
        self.final_time_fraction = final_time_fraction
        self.final_metrics = (
            LinearSolverMetrics(final_name) if final_name else None
        )
        self._setup_span = f"{name}.InputSetupTime"
        self._search = SearchGraphs(name)

    def coarse_of(self, grid_map):
        return self._series.coarse_of(grid_map)

    def _run(self, core, args, kw):
        """The match, and its dense re-run where a prune cannot certify the
        argmax; each result is fetched before the next search, which may
        replay the same graph (:class:`SearchGraphs`)."""
        kw = dict(kw, search=self._search)
        out = fetch(core(*args, **kw))
        if not out[-1]:
            MetricManager.instance().counter(
                f"{self.name}.DenseFallbacks"
            ).increment()
            out = fetch(core(*args, dense=True, **kw))
        return out

    def optimize_pose_deltas(self, fold, scan, initial_pose,
                             score_threshold: float = 0.0,
                             known_rate_threshold: float = 0.0
                             ) -> ScanMatchingSummary:
        t1 = time.perf_counter()
        sensor_pose = P.compound(initial_pose, scan.rel_sensor_pose)
        args = (
            self.ccfg, self.lcfg, fold["deltas"], fold["shifts"],
            fold["valid"], scan.ranges, scan.angles, scan.mask,
            to_device(sensor_pose, self.device, np.float32),
            to_device(fold["offset_xy"], self.device, np.float32),
            float(np.float32(score_threshold)),
            float(np.float32(known_rate_threshold)),
        )
        out = self._run(fused_core_deltas, args,
                        dict(max_shift=fold["max_shift"]))
        self.metrics.InputSetupTime.observe(0)
        return self._finish(out, initial_pose, scan, t1)

    def optimize_pose(self, query: ScanMatchingQuery,
                      score_threshold: float = 0.0,
                      known_rate_threshold: float = 0.0
                      ) -> ScanMatchingSummary:
        with MetricManager.instance().span(self._setup_span,
                                           self.metrics.InputSetupTime):
            gm, scan = query.grid_map, query.scan
            sensor_pose = P.compound(query.initial_pose, scan.rel_sensor_pose)
            coarse_p, coarse_o = self.coarse_of(gm)
        t1 = time.perf_counter()
        args = (
            self.ccfg, self.lcfg, gm.prob, gm.observed, coarse_p, coarse_o,
            scan.ranges, scan.angles, scan.mask,
            to_device(sensor_pose, self.device, np.float32),
            to_device(gm.offset_xy, self.device, np.float32),
            float(np.float32(score_threshold)),
            float(np.float32(known_rate_threshold)),
        )
        out = self._run(fused_body, args, {})
        return self._finish(out, query.initial_pose, scan, t1)

    def _finish(self, out, initial_pose, scan, t1) -> ScanMatchingSummary:
        (refined, cov, score, known, found, ncost, iters, n_proc, n_total,
         csm_pose, csm_ncost, _) = out
        est = P.move_backward(refined, scan.rel_sensor_pose)
        wall_us = int((time.perf_counter() - t1) * 1e6)
        frac = self.final_time_fraction if self.final_metrics else 0.0
        self.metrics.OptimizationTime.observe(int(wall_us * (1.0 - frac)))
        csm_est = P.move_backward(csm_pose, scan.rel_sensor_pose)

        class _Q:  # _observe_metrics reads only .initial_pose
            pass

        q = _Q()
        q.initial_pose = np.asarray(initial_pose)
        self._series._observe_metrics(
            q, scan, csm_est, score, csm_ncost, int(n_proc), int(n_total)
        )
        if self.final_metrics is not None:
            fm = self.final_metrics
            fm.OptimizationTime.observe(int(wall_us * frac))
            diff = P.inverse_compound(csm_est, est)
            fm.DiffTranslation.observe(float(P.distance(diff)))
            fm.DiffRotation.observe(abs(float(diff[2])))
            fm.NumOfIterations.observe(int(iters))
            fm.InitialCost.observe(float(csm_ncost))
            fm.FinalCost.observe(float(ncost))
            fm.NumOfScans.observe(int(scan.num_valid))
        return ScanMatchingSummary(
            pose_found=bool(found),
            normalized_cost=float(ncost),
            initial_pose=np.asarray(initial_pose),
            estimated_pose=est,
            covariance=cov,
            normalized_score=float(score),
            known_rate=float(known),
        )
