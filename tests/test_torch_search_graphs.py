"""The fused matcher's search graphs (``models/fused_matcher.py``:
``SearchGraphs``): which calls share a capture, which are kept, and what
runs at a capture and at a replay.  On the CPU, with the CUDA calls of a
capture stood in for (:func:`stand_in_cuda`): "graphs" that capture and
replay nothing, around sweeps that the capture records and a replay
runs.  The card tests (``test_torch_cuda.py``) hold the replays' bits."""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.matching import correlative
from my_lidar_graph_slam_v2_tpu_torch.matching.cost import CostConfig
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu_torch.models import fused_matcher
from my_lidar_graph_slam_v2_tpu_torch.ops import csm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = correlative.CorrelativeConfig(range_x=0.5, range_y=0.5,
                                    range_theta=0.3, n_theta_max=24,
                                    crop_rows=96, crop_cols=96,
                                    fine_theta_k=8, fine_block_b=4)
NAME = "Test.SearchGraphs"
COUNTERS = (f"{NAME}.GraphCaptures", f"{NAME}.GraphReplays")


def inputs(seed=0, *, coarse=False, beams=64, size=128):
    """A small room raster and a scan of its walls, as the search takes
    them: (prob, observed, coarse maps or None, ranges, angles, mask,
    sensor pose, raster offset)."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((size, size), bool)
    obs[8:-8, 8:-8] = True
    prob = np.where(obs, rng.integers(1, 30, (size, size)), 0)
    prob[20:22, 20:-20] = prob[-22:-20, 20:-20] = 230
    prob[20:-20, 20:22] = prob[20:-20, -22:-20] = 230
    prob = torch.as_tensor(prob.astype(np.uint8))
    obs = torch.as_tensor(obs)
    cp = co = None
    if coarse:
        cp, co = correlative.coarse_of(
            correlative.MapRaster(prob, obs, 0.05, np.zeros(2)),
            CFG.low_resolution)
    angles = np.linspace(-np.pi, np.pi, beams, endpoint=False)
    ranges = rng.uniform(1.5, 2.2, beams)
    return (prob, obs, cp, co, torch.as_tensor(ranges.astype(np.float32)),
            torch.as_tensor(angles.astype(np.float32)),
            torch.as_tensor(rng.uniform(size=beams) < 0.9),
            torch.as_tensor(rng.uniform(2.9, 3.5, 3).astype(np.float32)),
            torch.zeros(2))


class FakeGraph:
    """A CUDA graph that captures nothing and replays nothing."""

    def __init__(self):
        self.replays = 0

    def capture_begin(self, pool, capture_error_mode):
        assert pool == "pool" and capture_error_mode == "thread_local"

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


class FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in_cuda(monkeypatch):
    """Every search a capture, on the CPU: the capture's CUDA calls stood
    in for, and ``ops/csm.py:sweep`` counted.  Yields the sweeps run."""
    sweeps = []
    sweep = csm.sweep

    def counted(*args, **kw):
        sweeps.append(kw)
        return sweep(*args, **kw)

    monkeypatch.setattr(csm, "sweep", counted)
    monkeypatch.setattr(fused_matcher.SearchGraphs, "_captures",
                        lambda self, ccfg, prob: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    yield sweeps


def counts():
    mm = MetricManager.instance()
    return [mm.counter(n).value for n in COUNTERS]


def call(graphs, args, thresholds=(0.1, 0.2), dense=False, cfg=CFG):
    return graphs(cfg, *args, *thresholds, dense=dense)


def _f64(a):
    return None if a is None else a.double()


# Each field of the key, changed alone from the first call's inputs
VARIANTS = {
    "dense": dict(dense=True),
    "coarse maps given": dict(args=inputs(coarse=True)),
    "prob dtype": dict(args=(inputs()[0].float(),) + inputs()[1:]),
    "prob shape": dict(args=(inputs()[0][:, :120],) + inputs()[1:]),
    "observed dtype": dict(args=(inputs()[0], inputs()[1].to(torch.uint8))
                           + inputs()[2:]),
    "observed shape": dict(args=(inputs()[0], inputs()[1][:120])
                           + inputs()[2:]),
    "coarse map shapes": dict(
        args=inputs(coarse=True)[:2] + tuple(
            a[:, :120] for a in inputs(coarse=True)[2:4])
        + inputs(coarse=True)[4:],
        first=inputs(coarse=True)),
    "coarse map dtypes": dict(
        args=inputs(coarse=True)[:2] + tuple(
            _f64(a) for a in inputs(coarse=True)[2:4])
        + inputs(coarse=True)[4:],
        first=inputs(coarse=True)),
    "beams": dict(args=inputs(beams=48)),
    "beam mask dtype": dict(args=inputs()[:6] + (inputs()[6].to(torch.uint8),)
                            + inputs()[7:]),
    "score threshold": dict(thresholds=(0.15, 0.2)),
    "known rate threshold": dict(thresholds=(0.1, 0.25)),
    "config": dict(cfg=dataclasses.replace(CFG, fine_block_b=3)),
    "device": dict(args=tuple(None if a is None else a.to("meta")
                              for a in inputs())),
}


@pytest.mark.parametrize("field", list(VARIANTS))
def test_each_key_field_separates_keys(stand_in_cuda, monkeypatch, field):
    """A change of one field of the key captures a second time; the same
    fields with other values replay the first capture.  A search that
    takes any inputs stands in for the search."""
    v = VARIANTS[field]
    monkeypatch.setattr(fused_matcher, "correlative_core",
                        lambda ccfg, *a, dense=False, sweep_fn=None:
                        (torch.zeros(1),))
    graphs = fused_matcher.SearchGraphs(NAME)
    first = v.get("first", inputs())
    c0 = counts()
    call(graphs, first)
    call(graphs, v.get("args", first), v.get("thresholds", (0.1, 0.2)),
         v.get("dense", False), v.get("cfg", CFG))
    assert len(graphs._graphs) == 2
    again = tuple(None if a is None else a.clone() for a in first)
    call(graphs, again)
    assert len(graphs._graphs) == 2
    assert [a - b for a, b in zip(counts(), c0)] == [2, 1]


def test_the_newest_four_keys_are_kept(stand_in_cuda):
    """Keys beyond the four kept are dropped, the least recently used
    first; a dropped key captures again."""
    graphs = fused_matcher.SearchGraphs(NAME)
    thresholds = [(0.1 * k, 0.2) for k in range(6)]
    c0 = counts()
    for t in thresholds[:4]:
        call(graphs, inputs(), t)
    call(graphs, inputs(1), thresholds[0])  # a replay: 0 is the newest now
    call(graphs, inputs(), thresholds[4])  # drops 1
    call(graphs, inputs(), thresholds[5])  # drops 2
    kept = [k[-1][0] for k in graphs._graphs]
    assert kept == [0.1 * k for k in (3, 0, 4, 5)]
    call(graphs, inputs(), thresholds[1])  # captured again, drops 3
    assert [k[-1][0] for k in graphs._graphs] == [0.0, 0.4, 0.5, 0.1]
    assert [a - b for a, b in zip(counts(), c0)] == [7, 1]


def test_the_first_call_returns_its_eager_result(stand_in_cuda):
    """The first call at a key returns the eager search of its own inputs,
    on the CPU the plain search's bits; the capture reads clones of them,
    and a replay copies the next call's inputs into those clones and
    returns the capture's outputs."""
    for dense, coarse in ((False, False), (True, False), (False, True)):
        graphs = fused_matcher.SearchGraphs(NAME)
        args = inputs(3, coarse=coarse)
        want = correlative.correlative_core(CFG, *args, 0.1, 0.2, dense=dense)
        got = call(graphs, args, dense=dense)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        (replay,) = graphs._graphs.values()
        assert got is not replay.outputs
        assert all(a is None if b is None else
                   (torch.equal(a, b) and a.data_ptr() != b.data_ptr())
                   for a, b in zip(replay.inputs, args))
        nxt = inputs(4, coarse=coarse)
        assert call(graphs, nxt, dense=dense) is replay.outputs
        assert all(a is None if b is None else torch.equal(a, b)
                   for a, b in zip(replay.inputs, nxt))


def test_the_sweeps_run_at_replays_and_not_in_captures(stand_in_cuda):
    """A capture is three graphs around the search's two sweeps.  The
    capture runs no sweep (the first call's two are its eager run's); a
    replay runs the three graphs in turn and, between them, each sweep
    through ``ops/csm.py:sweep`` on the arguments the capture recorded,
    its result copied where the next graph reads it."""
    graphs = fused_matcher.SearchGraphs(NAME)
    sweeps = stand_in_cuda
    for k, dense in enumerate((False, True, False, True, False)):
        n0 = len(sweeps)
        call(graphs, inputs(k), dense=dense)
        assert len(sweeps) - n0 == 2
    # the coarse sweep (stride 5) then the fine one (stride 1), each call
    assert [kw["stride"] for kw in sweeps] == [5, 1] * 5
    by_dense = {key[1]: r for key, r in graphs._graphs.items()}
    pruned, dense = by_dense[False], by_dense[True]
    for replay, replays in ((pruned, 2), (dense, 1)):
        assert len(replay.steps) == 5
        assert [s.__self__.replays for s in replay.steps[::2]] == [
            replays] * 3
    # each recorded sweep's result is the buffer the next graph reads
    result, *args, kw = pruned.steps[1].args
    assert torch.equal(result, csm.sweep(*args, **kw))


def test_a_greedy_endpoint_cost_and_cpu_tensors_never_capture():
    """CPU tensors run the search eagerly, in a matcher too: no capture, no
    replay, no key kept, the plain search's bits.  On the card a
    GreedyEndpoint cost runs eagerly too."""
    graphs = fused_matcher.SearchGraphs(NAME)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert graphs._captures(CFG, on_card)
    assert graphs._captures(dataclasses.replace(CFG, cost=CostConfig()),
                            on_card)
    greedy = dataclasses.replace(CFG, cost=CostConfig(
        cost_type="GreedyEndpoint"))
    assert not graphs._captures(greedy, on_card)
    c0 = counts()
    for dense in (False, True, False):
        args = inputs(5)
        want = correlative.correlative_core(CFG, *args, 0.1, 0.2, dense=dense)
        for g, w in zip(call(graphs, args, dense=dense), want):
            assert torch.equal(g, w)
    assert counts() == c0 and not graphs._graphs
    from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
        LinearSolverConfig,
    )
    m = fused_matcher.FusedCorrelativeGNMatcher(CFG, LinearSolverConfig(),
                                                "cpu", name=NAME)
    prob, obs, _, _, ranges, angles, mask, pose, off = inputs(6)
    body = m._run(fused_matcher.fused_body,
                  (CFG, LinearSolverConfig(), prob, obs, None, None, ranges,
                   angles, mask, pose, off, 0.1, 0.2), {})
    want = fused_matcher.fused_body(CFG, LinearSolverConfig(), prob, obs,
                                    None, None, ranges, angles, mask, pose,
                                    off, 0.1, 0.2)
    np.testing.assert_array_equal(body[0], want[0].numpy())
    assert counts() == c0 and not m._search._graphs


@pytest.mark.parametrize("backend", ["matmul", "gather"])
def test_a_sweep_fn_takes_the_place_of_the_sweep(backend):
    """The search with ``sweep_fn`` calls it, and only it, for both
    sweeps, and gives the search's bits when it sweeps as
    ``ops/csm.py:sweep`` does."""
    cfg = dataclasses.replace(CFG, sweep_backend=backend)
    seen = []

    def sweep_fn(*args, **kw):
        seen.append(kw["stride"])
        return csm.sweep(*args, **kw)

    for dense in (False, True):
        args = inputs(7, coarse=backend == "gather")
        want = correlative.correlative_core(cfg, *args, 0.1, 0.2, dense=dense)
        got = correlative.correlative_core(cfg, *args, 0.1, 0.2, dense=dense,
                                           sweep_fn=sweep_fn)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert seen == [5, 1, 5, 1]
