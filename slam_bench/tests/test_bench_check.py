"""The check that decides ``correct``, at a size a test run holds: a sound
run passes it, the control (the reference one precision down in the
program's place) fails it, and so does a run with each planted fault; the
harness is driven as in a benchmark run, with the look for a chip
skipped.  The tests marked ``cuda`` repeat this on the card."""
from __future__ import annotations

import pytest
import torch

from slam_bench import faults, harness, trace
from slam_bench.tests import small

SEED = 2**31 + 101


def verdict(run, control=False):
    numbers = run.check(control=control)
    return harness.verdict(numbers, run.config["limits"]), numbers


@pytest.fixture(scope="module")
def sound():
    return small.run("ref_batched", SEED, 4.0)


def test_a_sound_run_is_correct(sound):
    (ok, checks), numbers = verdict(sound)
    assert ok, checks
    assert numbers["judged"]["matches"] > 0 and numbers["judged"]["loops"] > 0
    assert numbers["judged"]["lm_calls"] > 0 and numbers["judged"]["maps"] > 0


def test_the_control_is_not_correct(sound):
    (ok, checks), numbers = verdict(sound, control=True)
    assert not ok, checks
    assert numbers["map_cells"] > 0.5


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_is_not_correct(fault):
    run = small.run("ref_batched", SEED, 4.0,
                    faults=[faults.FAULTS[fault]])
    (ok, checks), _ = verdict(run)
    assert not ok, (fault, checks)


def test_the_serial_configuration_is_correct():
    (ok, checks), _ = verdict(small.run("ref_serial", SEED + 1, 3.0))
    assert ok, checks


def test_a_traced_run_reads_the_layers():
    run = small.run("ref_serial", SEED + 2, 4.0, trace_on=True)
    values = run.layer_values()
    for name in ("frontend.match_ms", "mapping.update_ms", "loop.detect_ms",
                 "graph.optimize_ms"):
        assert values[name]["value"] > 0, name
    # Off a CUDA device the device metrics find nothing to read.
    assert "device.idle_pct" not in values
    assert run.td.counts["keyframes"] > 0
    assert run.info["fenced_keyframes_per_s"] > 0
    (ok, checks), _ = verdict(run)
    assert ok, checks


def test_a_span_that_resolves_nowhere_raises():
    class Slam:
        def process_scan(self):
            return 1

    td = trace.TraceData(torch.device("cpu"))
    td.install(Slam(), [("a", ["process_scan", "missing"], None)])
    with pytest.raises(AttributeError, match="none of"):
        td.install(Slam(), [("b", ["frontend.missing"], None)])


def test_device_summary_arithmetic():
    ns = 1_000_000_000
    profile = dict(
        spans=[(0, 10 * ns, "window"), (1 * ns, 5 * ns, "frontend.match"),
               (2 * ns, 3 * ns, "kernel.sweep")],
        device=[(int(2.2 * ns), int(2.4 * ns), "sweep_kernel", True),
                (int(4.0 * ns), int(4.5 * ns), "Memcpy HtoD", False),
                (int(6.0 * ns), int(7.0 * ns), "other", True)])
    s = trace.device_summary(profile)
    assert s["launches"] == 2
    assert s["busy_s"] == pytest.approx(1.7)
    assert s["window_s"] == pytest.approx(10.0)
    assert s["span_device_s"]["kernel.sweep"] == pytest.approx(0.2)
    idle = dict(s["idle_gaps"])
    assert idle["idle in frontend.match"] == pytest.approx(2.2 + 1.6)
    assert idle["idle in outside layers"] == pytest.approx(1.5 + 3.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
def test_on_the_card_sound_passes_and_the_control_fails(card):
    cfg, traffic = small.small("ref_batched")
    run = harness.Run("ref_batched.revisit", SEED, card, config=cfg,
                      traffic=traffic)
    run.window(4.0)
    (ok, checks), _ = verdict(run)
    assert ok, checks
    (ok, checks), _ = verdict(run, control=True)
    assert not ok, checks
