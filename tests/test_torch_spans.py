"""The port's spans (``metrics/registry.py``: ``MetricManager.span``).

- Tracing off: a span with a series observes its block's microseconds
  into it, one without is a shared no-op, nothing is recorded, and a
  short ``create_default_slam`` course observes the same reference series
  with the same sample counts as before spans replaced the hand-written
  timers (the counts below were taken from that parent tree), less
  ``LoopDetector.MapStackBytes``, a port-only series removed with them.
- Tracing on: one record per keyframe; every child span lies inside its
  parent; the ``fetch`` spans count the rise of ``Device.HostFetches``;
  the poses equal the untraced run's bit for bit; under
  ``torch.profiler`` each span's ``record_function`` event lies inside
  the span's own ends (the two read one clock); a threaded backend's
  spans carry its thread.
"""
import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
    MetricManager,
    ValueSequence,
)
from my_lidar_graph_slam_v2_tpu_torch.pipeline import factory
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Samples each series gained over the course below, on the tree before
# spans (inline default backend, CPU).
PARENT_SERIES = {
    "Backend.EndAtLoopClosure": 5, "Backend.EndAtLoopDetection": 3,
    "Backend.EndAtLoopSearch": 10, "Backend.LoopDetectionSetupTime": 8,
    "Backend.LoopDetectionTime": 8, "Backend.LoopSearchSetupTime": 18,
    "Backend.LoopSearchTime": 18, "Backend.NumOfCandidates": 18,
    "Backend.OptimizationSetupTime": 5, "Backend.OptimizationTime": 5,
    "Backend.PoseGraphAppendTime": 5, "Backend.PoseGraphUpdateTime": 5,
    "Backend.ProcessStepTime": 5, "Backend.ProcessTime": 18,
    "Frontend.DataUpdateTime": 47, "Frontend.FinalScanMatchingTime": 46,
    "Frontend.IntervalAngle": 47, "Frontend.IntervalTime": 47,
    "Frontend.IntervalTravelDist": 47, "Frontend.NumOfScans": 47,
    "Frontend.PhysicalMemoryUsage": 47, "Frontend.ProcessFrame": 47,
    "Frontend.ProcessScanTime": 47, "Frontend.ProcessTime": 93,
    "Frontend.ScanDataSetupTime": 46, "Frontend.ScanMatchingTime": 46,
    "GridMapBuilder.LatestMapUpdateTime": 46,
    "GridMapBuilder.LocalMapIntervalTravelDist": 17,
    "GridMapBuilder.LocalMapMemoryUsage": 47,
    "GridMapBuilder.LocalMapUpdateTime": 47,
    "GridMapBuilder.NumOfEdges": 47, "GridMapBuilder.NumOfLocalMapNodes": 47,
    "GridMapBuilder.PoseGraphMemoryUsage": 47,
    "GridMapBuilder.PoseGraphUpdateTime": 47,
    "LidarGraphSlam.NumOfNewLoopEdges": 5,
    **{f"LocalSlam.FinalScanMatcherLinearSolver.{n}": 46 for n in (
        "DiffRotation", "DiffTranslation", "FinalCost", "InitialCost",
        "NumOfIterations", "NumOfScans", "OptimizationTime")},
    **{f"LocalSlam.ScanMatcherCorrelative.{n}": 46 for n in (
        "CostValue", "DiffRotation", "DiffTranslation", "InputSetupTime",
        "NumOfIgnoredNodes", "NumOfProcessedNodes", "NumOfScans",
        "OptimizationTime", "ScoreValue", "StepSizeTheta", "StepSizeX",
        "StepSizeY", "WinSizeTheta", "WinSizeX", "WinSizeY")},
    **{f"LoopDetector.FinalScanMatcherLinearSolver.{n}": 10 for n in (
        "DiffRotation", "DiffTranslation", "FinalCost", "InitialCost",
        "NumOfIterations", "NumOfScans", "OptimizationTime")},
    "LoopDetector.MapStackBytes": 8,
    "LoopSearcherNearest.AccumTravelDist": 18,
    "LoopSearcherNearest.NodeDist": 15,
    "LoopSearcherNearest.NumOfCandidateNodes": 18,
    "MapCache.MaterializedBytes": 4,
    **{f"PoseGraphOptimizerLM.{n}": 5 for n in (
        "FinalError", "InitialError", "NumOfEdges", "NumOfIterations",
        "NumOfLocalMapNodes", "NumOfScanNodes")},
}
REMOVED = {"LoopDetector.MapStackBytes"}
KEYFRAMES = 47


def _lengths(mm):
    return {n: len(m.values) for n, m in list(mm.metrics.items())
            if type(m) is ValueSequence}


def _course(inline=True, scans=None):
    """tests/test_torch_runtime.py's 10 m office on the CPU, 1.25 laps:
    (slam, keyframes, samples each series gained)."""
    world = synthetic.World.office(seed=21, size=10.0)
    traj = synthetic.loop_trajectory(size=10.0, laps=1.25, step=0.3)
    seq = synthetic.generate(world, traj, n_beams=121, max_range=10.0,
                             range_noise=0.01, odom_noise=(0.05, 0.02),
                             seed=22)
    mm = MetricManager.instance()
    before = _lengths(mm)
    backend = factory.create_default_backend(
        usable_range_max=10.0, n_theta_max=48, crop=256, beam_capacity=256,
        inline=inline, device="cpu",
        searcher_overrides=dict(travel_dist_threshold=10.0,
                                node_dist_threshold=5.0))
    slam = factory.create_default_slam(
        map_rows=384, map_cols=384, beam_capacity=256, samples_per_beam=192,
        usable_range_max=10.0, n_theta_max=48, crop=256, backend=backend,
        builder_overrides=dict(travel_dist_threshold=1.5), device="cpu")
    slam.start_backend()
    keyframes = 0
    for scan in seq.scans[:scans]:
        keyframes += bool(slam.process_scan(scan, scan.odom_pose))
    slam.stop_backend()
    added = {n: k - before.get(n, 0) for n, k in _lengths(mm).items()
             if k - before.get(n, 0)}
    return slam, keyframes, added


@pytest.fixture(scope="module")
def runs():
    """The course untraced, then traced (its spans after the last
    keyframe closed into one more record)."""
    mm = MetricManager.instance()
    assert not mm.tracing
    n_records = len(mm.trace_records())
    off = _course()
    assert len(mm.trace_records()) == n_records
    fetches0 = mm.counter("Device.HostFetches").value
    mm.start_tracing()
    try:
        on = _course()
        mm.close_record()
    finally:
        mm.stop_tracing()
    return off, on, list(mm.trace_records()), fetches0


def test_a_span_times_its_block_into_its_series():
    mm = MetricManager()
    series = mm.value_sequence("S")
    assert mm.span("a") is mm.span("b")  # no series: one shared no-op
    with mm.span("a"):
        pass
    with mm.span("a", series) as sp:
        assert sp.us() >= 0
    with mm.span("a", series) as sp:
        sp.drop()
    with pytest.raises(RuntimeError):
        with mm.span("a", series):
            raise RuntimeError
    assert len(series.values) == 1 and series.values[0] >= 0
    assert mm.trace_records() == []


def test_tracing_off_keeps_the_reference_series(runs):
    (slam, keyframes, added), _, _, _ = runs
    assert keyframes == KEYFRAMES
    want = {n: k for n, k in PARENT_SERIES.items() if n not in REMOVED}
    assert added == want


def test_tracing_on_keeps_a_record_per_keyframe(runs):
    _, (slam, keyframes, added), records, _ = runs
    assert keyframes == KEYFRAMES
    assert len(records) == KEYFRAMES + 1  # and the spans after the last
    assert added == runs[0][2]
    for rec in records[:-1]:
        roots = {s[0] for s in rec.spans if s[1] == ""}
        assert roots == {"process_scan"}
    for rec in records[1:-1]:  # a keyframe matched against the map
        assert {"frontend.match", "match.fold", "match.search",
                "match.refine", "fetch", "mapping.update"} <= \
            {s[0] for s in rec.spans}
    names = {s[0] for r in records for s in r.spans}
    assert {"backend.step", "loop.detect", "graph.optimize", "graph.prepare",
            "graph.solve", "graph.write_back"} <= names
    for rec in records:
        assert set(rec.lengths) >= {"Frontend.ProcessTime"}
        assert "Device.HostFetches" in rec.counters


def test_children_lie_inside_their_parents(runs):
    spans = [s for r in runs[2] for s in r.spans]
    opened = {}
    for name, parent, t0, t1, thread in spans:
        path = f"{parent}/{name}" if parent else name
        opened.setdefault((path, thread), []).append((t0, t1))
    for name, parent, t0, t1, thread in spans:
        assert t0 <= t1
        if parent:
            assert any(a <= t0 and t1 <= b
                       for a, b in opened[(parent, thread)]), (name, parent)


def test_fetch_spans_count_the_host_fetches(runs):
    records, fetches0 = runs[2], runs[3]
    spans = [s for r in records for s in r.spans if s[0] == "fetch"]
    assert spans
    assert len(spans) == records[-1].counters["Device.HostFetches"] - fetches0
    # each record's counter rose by its own fetch spans
    prev = fetches0
    for rec in records:
        now = rec.counters["Device.HostFetches"]
        assert now - prev == sum(1 for s in rec.spans if s[0] == "fetch")
        prev = now


def test_tracing_leaves_the_poses_bitwise(runs):
    off, on = runs[0][0], runs[1][0]
    assert np.array_equal(off.get_trajectory(), on.get_trajectory())


def test_record_function_events_share_the_spans_clock():
    mm = MetricManager.instance()
    mm.start_tracing()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _course(scans=40)
        mm.close_record()
        spans = [s for r in mm.trace_records() for s in r.spans]
    finally:
        mm.stop_tracing()
    names = {s[0] for s in spans}
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in names and ev.is_user_annotation():
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    assert {"process_scan", "frontend.match", "fetch"} <= set(events)
    slack = 100_000  # ns
    for name, evs in events.items():
        mine = sorted((s[2], s[3]) for s in spans if s[0] == name)
        assert len(evs) == len(mine), name
        for (e0, e1), (t0, t1) in zip(sorted(evs), mine):
            assert t0 - slack <= e0 and e1 <= t1 + slack, (name, e0 - t0,
                                                          t1 - e1)


def test_a_threaded_backend_traces_on_its_thread():
    mm = MetricManager.instance()
    mm.start_tracing()
    try:
        slam, keyframes, _ = _course(inline=False)
        mm.close_record()
        spans = [s for r in mm.trace_records() for s in r.spans]
    finally:
        mm.stop_tracing()
    assert slam.backend_error is None and keyframes == KEYFRAMES
    steps = [s for s in spans if s[0] == "backend.step"]
    assert steps and {s[4] for s in steps} == {"slam-backend", "MainThread"}
    assert {s[1] for s in steps} == {""}  # roots on either thread
    front = {s[4] for s in spans if s[0] == "frontend.match"}
    assert front == {"MainThread"}
