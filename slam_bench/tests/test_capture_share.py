"""``graph.capture_share``: the program's ``graph.capture`` spans below
``graph.solve`` over its ``graph.solve`` spans, in the traced window's
unfenced half, on the records of ``test_program_spans.py``."""
from __future__ import annotations

import types

import pytest

from slam_bench import harness, program_spans
from slam_bench.tests.test_program_spans import (
    M, RECORDS, STEP, TD, Program, keyframe, record, span)


@pytest.fixture
def program(monkeypatch):
    p = Program(RECORDS)
    monkeypatch.setattr(program_spans, "_manager", lambda: p)
    return p


def _with_captures(record_, n):
    """``record_`` with ``n`` ``graph.capture`` spans below its
    ``graph.solve``."""
    g = STEP + "/graph.optimize/graph.solve"
    return record(*record_.spans, *[span("graph.capture", g, 42, 3)] * n)


def test_capture_share_counts_captures_over_solves(program):
    mod = harness.load_metric("graph.capture_share")
    declared = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    assert declared["graph.capture_share"]["source"] == "program_span"
    assert mod.SPANS == []
    assert program.started == [False]
    # no capture: every call replayed (or ran eagerly, as the parent)
    assert mod.read(TD) == 0.0
    # one capture in the unfenced half's one solve; none counted from the
    # warm-up or the fenced half
    program.records = [_with_captures(RECORDS[0], 2),
                       _with_captures(RECORDS[1], 1), RECORDS[2],
                       _with_captures(RECORDS[3], 2)]
    assert mod.read(TD) == 1.0
    two = types.SimpleNamespace(unfenced=dict(keyframes=3),
                                counts=dict(keyframes=1))
    program.records = [keyframe(1, step=True),
                       _with_captures(keyframe(1, step=True), 1),
                       keyframe(1, step=True), keyframe(1000, True, True)]
    assert mod.read(two) == pytest.approx(1 / 3)
    # a capture span outside graph.solve is not the LM's
    program.records = [RECORDS[0], record(*RECORDS[1].spans,
                                          span("graph.capture", M, 0, 1)),
                       RECORDS[2], RECORDS[3]]
    assert mod.read(TD) == 0.0


def test_capture_share_without_a_solve_is_none(program, monkeypatch):
    mod = harness.load_metric("graph.capture_share")
    program.records = [keyframe(), keyframe(), keyframe(), keyframe()]
    assert mod.read(TD) is None
    assert mod.read(types.SimpleNamespace(unfenced=None, counts={})) is None
    # a program without span tracing (the parent of the port's spans)
    monkeypatch.setattr(program_spans, "_manager", lambda: object())
    program_spans.start()
    assert mod.read(TD) is None
