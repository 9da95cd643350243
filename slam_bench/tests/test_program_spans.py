"""The per-layer metrics that read the program's own spans
(``program_spans.py``): each takes the traced window's unfenced half,
the records ``[-(U + F):-F]``, and nothing before or after it."""
from __future__ import annotations

import types

import pytest

from slam_bench import harness, program_spans

MS = 1_000_000  # ns


def span(name, parent, t0_ms, ms, thread="MainThread"):
    return (name, parent, t0_ms * MS, (t0_ms + ms) * MS, thread)


def record(*spans):
    return types.SimpleNamespace(spans=list(spans), counters={}, lengths={})


F_PATH = "process_scan/Frontend.ProcessTime"
M = F_PATH + "/frontend.match"
STEP = F_PATH + "/backend.step"


def keyframe(scale=1, dense=False, step=False):
    """One keyframe's spans, every time times ``scale``."""
    s = scale
    spans = [span("match.fold", M, 0, 1 * s), span("match.search", M, 1, 2 * s),
             span("match.refine", M, 3, 4 * s), span("fetch", M, 7, 1 * s)]
    if dense:
        spans += [span("match.search", M, 8, 2 * s), span("fetch", M, 10, s)]
    spans.append(span("frontend.match", F_PATH, 0, 12 * s))
    if step:
        d, g = STEP + "/loop.detect", STEP + "/graph.optimize"
        spans += [
            span("match.search", d, 20, 5 * s), span("fetch", d, 25, s),
            span("match.refine", d + "/Final.OptimizationTime", 26, 6 * s),
            span("fetch", d + "/Final.OptimizationTime", 32, s),
            span("loop.detect", STEP, 20, 14 * s),
            span("graph.prepare", g, 40, 2 * s),
            span("graph.solve", g, 42, 8 * s), span("fetch", g, 50, 3 * s),
            span("graph.optimize", STEP, 40, 14 * s),
        ]
    return record(*spans)


# warm-up (times x100), the unfenced half (2 keyframes, one with a dense
# re-run and a backend step), the fenced half (1 keyframe, times x1000)
RECORDS = [keyframe(100, True, True), keyframe(1, step=True),
           keyframe(1, dense=True), keyframe(1000, True, True)]
TD = types.SimpleNamespace(unfenced=dict(keyframes=2),
                           counts=dict(keyframes=1))

WANT = {
    "frontend.fold_ms": 1.0, "frontend.search_ms": 3.0,
    "frontend.refine_ms": 4.0, "frontend.wait_ms": 1.5,
    "frontend.dense_share": 0.5, "device.fetches_per_kf": 3.0,
    "loop.search_ms": 5.0, "loop.refine_ms": 6.0, "loop.wait_ms": 2.0,
    "graph.prepare_ms": 2.0, "graph.solve_ms": 8.0, "graph.wait_ms": 3.0,
}


class Program:
    def __init__(self, records=None):
        self.records, self.started = records, []

    def start_tracing(self, ranges=True):
        self.started.append(ranges)

    def trace_records(self):
        return self.records


@pytest.fixture
def program(monkeypatch):
    p = Program(RECORDS)
    monkeypatch.setattr(program_spans, "_manager", lambda: p)
    return p


def test_every_new_metric_is_declared_and_reads_its_spans(program):
    declared = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    for name, want in WANT.items():
        assert declared[name]["source"] == "program_span"
        mod = harness.load_metric(name)
        assert mod.SPANS == []
        assert mod.read(TD) == pytest.approx(want), name
    # each module turned the program's tracing on when it loaded, without
    # its profiler ranges
    assert program.started == [False] * len(WANT)


def test_the_unfenced_half_runs_to_the_end_when_nothing_follows(program):
    td = types.SimpleNamespace(unfenced=dict(keyframes=2),
                               counts=dict(keyframes=0))
    program.records = RECORDS[:3]
    assert harness.load_metric("frontend.fold_ms").read(td) == 1.0
    spans, kf = program_spans.unfenced(td)
    assert kf == 2 and len(spans) == 2 * 5 + 2 + 9


def test_nothing_to_read_gives_none(program, monkeypatch):
    mod = harness.load_metric("frontend.refine_ms")
    assert mod.read(types.SimpleNamespace(unfenced=None, counts={})) is None
    # fewer records than the half's keyframes: tracing began too late
    program.records = RECORDS[-2:]
    assert mod.read(TD) is None
    # no backend step in the half: per-step metrics have nothing to read
    program.records = [keyframe(), keyframe(), keyframe()]
    assert harness.load_metric("loop.search_ms").read(TD) is None
    # a program without span tracing (the parent of the port's spans)
    monkeypatch.setattr(program_spans, "_manager", lambda: object())
    program_spans.start()
    assert mod.read(TD) is None
