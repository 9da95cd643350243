"""``frontend.replay_share``: the program's ``search.replay`` spans below
``frontend.match`` over its ``match.search`` spans there, in the traced
window's unfenced half, on the records of ``test_program_spans.py``."""
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


def _graphed(record_, *kinds, under=M + "/match.search"):
    """``record_`` with a span of each of ``kinds`` (``search.capture`` or
    ``search.replay``) below ``under``."""
    return record(*record_.spans, *[span(k, under, 1, 1) for k in kinds])


def test_replay_share_counts_replays_over_frontend_searches(program):
    mod = harness.load_metric("frontend.replay_share")
    declared = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    m = declared["frontend.replay_share"]
    assert (m["source"], m["unit"], m["better"], m["moves"]) == (
        "program_span", "share", "higher", "keyframes_per_s")
    assert m["layer"] == "frontend scan matching"
    assert m["workloads"] == ["ref_batched.revisit", "ref_serial.revisit",
                              "ref_batched.explore"]
    assert mod.SPANS == []
    assert program.started == [False]
    # the unfenced half: a keyframe with one search, replayed, and one
    # with a dense re-run, both replayed; none counted from the warm-up
    # or the fenced half
    program.records = [
        _graphed(RECORDS[0], "search.capture", "search.capture"),
        _graphed(RECORDS[1], "search.replay"),
        _graphed(RECORDS[2], "search.replay", "search.replay"),
        _graphed(RECORDS[3], "search.replay", "search.replay")]
    assert mod.read(TD) == 1.0
    # the dense re-run captured: 2 replays of 3 searches
    program.records[2] = _graphed(RECORDS[2], "search.replay",
                                  "search.capture")
    assert mod.read(TD) == pytest.approx(2 / 3)
    # every search of the half captured
    program.records[1:3] = [
        _graphed(RECORDS[1], "search.capture"),
        _graphed(RECORDS[2], "search.capture", "search.capture")]
    assert mod.read(TD) == 0.0
    # the loop detector's replays (below loop.detect) are not the
    # frontend's
    d = STEP + "/loop.detect/match.search"
    program.records = [RECORDS[0],
                       _graphed(RECORDS[1], "search.replay", "search.replay",
                                under=d),
                       _graphed(RECORDS[2], "search.replay"), RECORDS[3]]
    assert mod.read(TD) == pytest.approx(1 / 3)


def test_replay_share_without_a_search_or_spans_is_none(program,
                                                        monkeypatch):
    mod = harness.load_metric("frontend.replay_share")
    # no frontend search in the half
    no_match = record(span("mapping.update", "process_scan", 0, 1))
    program.records = [RECORDS[0], no_match, no_match, RECORDS[3]]
    assert mod.read(TD) is None
    assert mod.read(types.SimpleNamespace(unfenced=None, counts={})) is None
    # searches, none captured or replayed (the parent: an eager search)
    program.records = RECORDS
    assert mod.read(TD) is None
    two = types.SimpleNamespace(unfenced=dict(keyframes=3),
                                counts=dict(keyframes=1))
    program.records = [keyframe(), keyframe(dense=True),
                       _graphed(keyframe(), "search.replay"), keyframe()]
    assert mod.read(two) == pytest.approx(1 / 4)
    # a program without span tracing
    monkeypatch.setattr(program_spans, "_manager", lambda: object())
    program_spans.start()
    assert mod.read(TD) is None
