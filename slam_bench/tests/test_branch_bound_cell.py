"""The cell ``ref_branchbound.revisit``: its configuration builds the
batched branch-and-bound detector, its check passes a sound run and fails
a planted fault, and its new readers (``loop.bb_*``, ``hits.*``) read
synthetic spans and traces as they should, and nothing from a program
without them."""
from __future__ import annotations

import types

import pytest
import torch

from slam_bench import bounds, faults, harness, trace
from slam_bench.tests import small
from slam_bench.tests.test_program_spans import (
    RECORDS, STEP, TD, Program, keyframe, record, span)

SEED = 2**31 + 301
CELL = "ref_branchbound.revisit"


@pytest.fixture
def program(monkeypatch):
    from slam_bench import program_spans

    p = Program(RECORDS)
    monkeypatch.setattr(program_spans, "_manager", lambda: p)
    return p


def _with_bb(record_, rounds, bound_ms=2, round_ms=3):
    """``record_`` with branch-and-bound's spans inside its step's
    ``loop.detect``: one ``bb.bound``, and ``rounds`` rounds in one
    ``bb.descend``."""
    s = STEP + "/loop.detect/match.search"
    extra = [span("bb.bound", s, 20, bound_ms)]
    extra += [span("bb.round", s + "/bb.descend", 22 + i * round_ms, round_ms)
              for i in range(rounds)]
    extra.append(span("bb.descend", s, 22, rounds * round_ms))
    return record(*record_.spans, *extra)


def test_the_cell_and_its_metrics_are_declared():
    b = harness.load_benchmark()
    cell = harness.find_cell(b, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "ref_branchbound", "revisit", 1)
    per = {m["name"]: m for m in harness.metrics_of(b["per_layer"], CELL)}
    for name in ("loop.bb_bound_ms", "loop.bb_descend_ms",
                 "loop.bb_rounds_per_step", "hits.build_roofline",
                 "hits.sweep_roofline"):
        assert per[name]["workloads"] == [CELL]
        assert per[name]["moves"] == "keyframe_p95_ms"
    # every metric of the other cells that reads a layer this cell runs
    for name in ("frontend.match_ms", "mapping.update_ms", "loop.detect_ms",
                 "graph.optimize_ms", "device.idle_pct", "sweep_roofline"):
        assert name in per


def test_rounds_and_times_per_step_read_the_bb_spans(program):
    rounds = harness.load_metric("loop.bb_rounds_per_step")
    bound = harness.load_metric("loop.bb_bound_ms")
    descend = harness.load_metric("loop.bb_descend_ms")
    # the unfenced half is RECORDS[1:3]: one step, in RECORDS[1]
    program.records = [_with_bb(RECORDS[0], 5), _with_bb(RECORDS[1], 2),
                       RECORDS[2], _with_bb(RECORDS[3], 7)]
    assert rounds.read(TD) == 2.0
    assert bound.read(TD) == pytest.approx(2.0)
    assert descend.read(TD) == pytest.approx(6.0)
    two = types.SimpleNamespace(unfenced=dict(keyframes=2),
                                counts=dict(keyframes=1))
    program.records = [keyframe(), _with_bb(keyframe(step=True), 1),
                       _with_bb(keyframe(step=True), 2),
                       keyframe(1000, True, True)]
    assert rounds.read(two) == pytest.approx(1.5)


def test_the_bb_metrics_read_nothing_without_the_spans(program, monkeypatch):
    names = ("loop.bb_rounds_per_step", "loop.bb_bound_ms",
             "loop.bb_descend_ms")
    # the correlative detector's steps: no bb span
    for name in names:
        assert harness.load_metric(name).read(TD) is None
    # a program without span tracing (the parent of the port's spans)
    from slam_bench import program_spans
    monkeypatch.setattr(program_spans, "_manager", lambda: object())
    for name in names:
        assert harness.load_metric(name).read(TD) is None


def _summary(spans, device):
    return trace.device_summary(dict(spans=spans, device=device))


def test_build_roofline_counts_the_images_once_and_the_fill():
    """Two candidates at the cell's shape: the images written once, less
    the 50 MB the L2 cache may hold unwritten when the build ends, and the
    rows and columns read once; the memset and the kernel of each fenced
    call both count as device time, also where the profiler's clock puts
    the memset's start before the call's range."""
    mod = harness.load_metric("hits.build_roofline")
    assert mod.SPANS[0][0] == "kernel.hits"
    rows = torch.zeros((2 * 208, 512), dtype=torch.int32)
    ms = mod.WORK["kernel.hits"](rows, rows, crop_rows=448, crop_cols=448)
    nbytes = 2 * 208 * 448 * 448 * 4 - 50 * 2**20 + 2 * 2 * 208 * 512 * 4
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert ms == bounds.bound(nbytes, 0)[0]
    # images smaller than the cache: only the rows and columns count
    small = torch.zeros((16, 40), dtype=torch.int32)
    assert mod.WORK["kernel.hits"](small, small, crop_rows=64,
                                   crop_cols=64) == bounds.bound(
        2 * 16 * 40 * 4, 0)[0]
    us = 1000
    profile = dict(
        spans=[(0, 10_000 * us, "window"),
               (100 * us, 300 * us, "kernel.hits"),
               (1000 * us, 1200 * us, "kernel.hits"),
               (2000 * us, 2200 * us, "kernel.hits")],
        device=[(50 * us, 90 * us, "before", True),
                (90 * us, 170 * us, "Memset (Device)", False),
                (170 * us, 240 * us, "hit_images_kernel", True),
                (400 * us, 500 * us, "other", True),
                (1010 * us, 1070 * us, "Memset (Device)", False),
                (1070 * us, 1140 * us, "hit_images_kernel", True)])
    # the third call's operations went unrecorded: it counts for nothing
    td = types.SimpleNamespace(profile=profile,
                               span_n={"kernel.hits": 3},
                               work_ms={"kernel.hits": 3 * ms})
    assert mod.recorded_calls(profile, "kernel.hits") == (
        2, pytest.approx(150e-6 + 130e-6))
    assert mod.read(td) == pytest.approx(100.0 * 2 * ms / 0.280)
    for empty in (types.SimpleNamespace(profile=None, span_n={}, work_ms={}),
                  types.SimpleNamespace(profile=dict(spans=[], device=[]),
                                        span_n={"kernel.hits": 1},
                                        work_ms={"kernel.hits": ms})):
        assert mod.read(empty) is None


def test_sweep_roofline_counts_the_csm_sweep_of_the_same_poses():
    """Three windows of two candidates' images: each window's crop, T x B
    beam cells, one origin, the scores and known counts, one add per
    valid pair and offset, as ``sweep_bound`` counts a CSM sweep."""
    from my_lidar_graph_slam_v2_tpu_torch.ops.csm import HitImages

    mod = harness.load_metric("hits.sweep_roofline")
    rows = torch.full((2, 16, 40), -1, dtype=torch.int32)
    rows[0, :, :30] = 3   # 480 valid pairs
    rows[1, :4, :10] = 5  # 40
    hits = HitImages(torch.zeros((2, 16, 64, 64)), rows,
                     torch.zeros(2, dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int32))
    prob = torch.zeros((1, 128, 128), dtype=torch.uint8)
    x0 = torch.zeros(3, dtype=torch.int32)
    ms = mod.WORK["kernel.hits_sweep"](
        hits, prob, prob, x0, x0, nx=8, ny=8, stride=1, precision="split",
        cand=[0, 0, 1], map_index=None)
    assert ms == bounds.sweep_bound(3, 16, 40, 71, 71, 1, 64,
                                    480 + 480 + 40)[0]
    # the bound sweep: strided offsets over the pyramid
    ms = mod.WORK["kernel.hits_sweep"](
        hits, prob, prob, x0[:2], x0[:2], nx=7, ny=7, stride=8,
        precision="split", cand=[0, 1])
    assert ms == bounds.sweep_bound(2, 16, 40, 112, 112, 1, 49, 520)[0]
    s = _summary([(0, 10**9, "window"), (10, 2000, "kernel.hits_sweep")],
                 [(100, 1100, "gemm", True)])
    td = types.SimpleNamespace(device_summary=s,
                               work_ms={"kernel.hits_sweep": 1e-6})
    assert mod.read(td) == pytest.approx(100.0 * 1e-9 / 1e-6)


def test_the_configuration_builds_the_batched_branch_bound_detector():
    from my_lidar_graph_slam_v2_tpu_torch.parallel.loop_sharded import (
        LoopDetectorShardedBranchBound,
    )

    cfg = harness.load_config("ref_branchbound")
    assert cfg["reference"]["detect"]["low_resolution"] == 1
    assert "hit_images" in cfg["kernels"]
    slam = harness.build_system(cfg, torch.device("cpu"))
    det = slam.backend.loop_detector
    assert isinstance(det, LoopDetectorShardedBranchBound)
    assert det.mcfg.node_height_max == 6 and det.mcfg.crop_rows == 448
    assert det.mcfg.n_theta_max == 208 and det.mcfg.blocks == (7, 7)
    assert (det.cfg.score_threshold, det.cfg.known_rate_threshold) == (
        0.55, 0.6)


def verdict(run):
    numbers = run.check()
    return harness.verdict(numbers, run.config["limits"]), numbers


def test_a_sound_run_is_correct_and_a_halved_detect_is_not():
    (ok, checks), numbers = verdict(small.run("ref_branchbound", SEED, 4.0))
    assert ok, checks
    assert numbers["detect_wrong"] == 0.0
    assert numbers["judged"]["queries"] > 0 and numbers["judged"]["loops"] > 0
    run = small.run("ref_branchbound", SEED, 4.0,
                    faults=[faults.FAULTS["detect_half"]])
    (ok, checks), numbers = verdict(run)
    assert not ok, checks
    assert numbers["detect_wrong"] > 0.2
