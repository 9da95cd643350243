"""The LM's shape buckets: the wrapper pads every graph as the JAX wrapper
does (``my_lidar_graph_slam_v2_tpu/graph/optimizer.py``), and the padding
changes nothing but the last bits of f64 sums.

The padded LM is held to ``optimize_core`` on the graph's own shapes:
the same iterations, lambda and initial error, and f32 poses within one
ulp.  The ulp is the padding's only room: its zeros change the length of
the f64 sums and of the Cholesky factorization, which can move an f64
result's last bits, as LAPACK and cuSOLVER do (``utils/devmath.py``), and
so, near a rounding boundary, an f32 pose's last bit.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.graph import optimizer as joptimizer
from my_lidar_graph_slam_v2_tpu_torch.graph import optimizer
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from torch_lm_cases import core_lm, loop_graph, walk_graph
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRAPHS = {
    "loop": lambda: loop_graph(np.random.default_rng(3)),
    # (seed, maps, scans a map, loop edges)
    "walk 20x10": lambda: walk_graph(0, 20, 10, 30),
    "walk 40x15": lambda: walk_graph(1, 40, 15, 60),
    "walk 60x11": lambda: walk_graph(2, 60, 11, 90),
    # N = 32 and M = 16: no node slot is padded
    "walk 16x2": lambda: walk_graph(5, 16, 2, 8),
    "walk 6x8": lambda: walk_graph(3, 6, 8, 6),
    "walk 10x9": lambda: walk_graph(4, 10, 9, 12),
}
# The dense solve's matrix is 3 (Mb + Nb) square: the small graphs only
CASES = ([("schur", g) for g in GRAPHS]
         + [("dense", g) for g in ("loop", "walk 16x2", "walk 6x8",
                                    "walk 10x9")])


@pytest.mark.parametrize("solver,graph", CASES)
def test_padded_lm_equals_the_lm_on_the_graphs_own_shapes(solver, graph):
    mp, sp, edges = GRAPHS[graph]()
    cfg = optimizer.OptimizerConfig(solver=solver)
    opt = optimizer.PoseGraphOptimizer(cfg, device="cpu")
    for call in range(2):  # the second call starts from the kept lambda
        lam = opt.lam
        pm, ps, st = opt.optimize(mp, sp, edges)
        um, us, (_, ulam, iters, init_err) = core_lm(
            cfg, mp, sp, edges, lam, "cpu")
        assert pm.shape == mp.shape and ps.shape == sp.shape
        assert st["iterations"] == iters > 0
        assert np.float32(opt.lam) == np.float32(ulam)
        assert st["initial_error"] == init_err
        np.testing.assert_array_max_ulp(pm.astype(np.float32), um, maxulp=1)
        np.testing.assert_array_max_ulp(ps.astype(np.float32), us, maxulp=1)
        mp, sp = pm, ps


class _Recorded(Exception):
    pass


@pytest.mark.parametrize("graph", ["loop", "walk 16x2"])
def test_buckets_and_padding_are_the_jax_wrappers(graph, monkeypatch):
    """The JAX wrapper's padded inputs to its LM, against the port's: the
    same buckets, poses, edges and padded indices (``walk 16x2`` pads no
    node slot, ``loop`` both), the same Schur pairs in another order."""
    mp, sp, edges = GRAPHS[graph]()
    seen = {}

    def record(cfg, Mb, Nb, *arrays):
        seen.update(Mb=Mb, Nb=Nb, arrays=[np.asarray(a) for a in arrays])
        raise _Recorded

    monkeypatch.setattr(joptimizer, "_optimize_core", record)
    with pytest.raises(_Recorded):
        joptimizer.PoseGraphOptimizer().optimize(mp, sp, edges)
    jmp, jsp, jmi, jsi, jil, jrl, jim, jp1, jp2, _ = seen["arrays"]

    info = optimizer.clip_info(edges[4], optimizer.OptimizerConfig().info_clip)
    pmp, psp, (mi, si, il, rl, im), real = optimizer.pad_graph(
        mp, sp, edges[:4] + (info,))
    M, N, E = len(mp), len(sp), len(edges[0])
    assert (seen["Mb"], seen["Nb"]) == (len(pmp), len(psp))
    assert (len(pmp) == M) == (graph == "walk 16x2")
    assert (len(psp) == N) == (graph == "walk 16x2")
    for a, b in ((jmp, pmp), (jsp, psp), (jmi, mi), (jsi, si), (jil, il),
                 (jrl, rl), (jim, im)):
        np.testing.assert_array_equal(a, b)
    assert real.tolist() == [True] * E + [False] * (len(mi) - E)
    p1, p2 = optimizer.schur_pairs(si, real)
    assert len(p1) == len(jp1) and len(p2) == len(jp2)
    P = E + sum(int(k) * (int(k) - 1)
                for k in np.bincount(np.asarray(edges[1])))
    assert (p1[P:] == len(mi) - 1).all() and (jp1[P:] == len(mi) - 1).all()
    assert sorted(zip(p1.tolist(), p2.tolist())) == sorted(
        zip(jp1.tolist(), jp2.tolist()))


def test_the_cpu_never_captures():
    mm = MetricManager.instance()
    names = ("PoseGraphOptimizerLM.GraphCaptures",
             "PoseGraphOptimizerLM.GraphReplays")
    before = [mm.counter(n).value for n in names]
    mp, sp, edges = GRAPHS["loop"]()
    opt = optimizer.PoseGraphOptimizer(device="cpu")
    for _ in range(3):
        opt.optimize(mp, sp, edges)
    assert [mm.counter(n).value for n in names] == before
    assert not opt._graphs


def test_one_graph_per_bucket_and_the_newest_four_kept(monkeypatch):
    """The wrapper's bookkeeping of captured graphs, on the CPU with a
    stand-in for the capture that runs the LM eagerly: one capture per
    new (solver, Mb, Nb, Eb, Pb), a replay for every other call, at most
    four graphs kept, the least recently used dropped, and the results
    those of the eager LM."""
    captured = []

    class Eager:
        @classmethod
        def capture(cls, cfg, n_maps, n_scans, mp, sp, shard, lam0):
            captured.append((cfg.solver, n_maps, n_scans, len(shard.map_idx),
                             len(shard.pair_e1)))
            return cls()

        def __call__(self, mp, sp, shard, lam0):
            return optimizer.optimize_core(
                optimizer.OptimizerConfig(), len(mp), len(sp), mp, sp,
                [shard], lam0)

    monkeypatch.setattr(optimizer, "_Replay", Eager)
    mm = MetricManager.instance()
    names = ("PoseGraphOptimizerLM.GraphCaptures",
             "PoseGraphOptimizerLM.GraphReplays")
    before = [mm.counter(n).value for n in names]
    graphed = optimizer.PoseGraphOptimizer(device="cpu")
    graphed._replays = lambda shards: len(shards) == 1
    eager = optimizer.PoseGraphOptimizer(device="cpu")
    # buckets A, A, B, C, D, E (A dropped), A again
    sizes = [(4, 9, 2), (4, 10, 2), (6, 12, 4), (10, 13, 8), (16, 16, 20),
             (20, 16, 30), (4, 9, 2)]
    for seed, (m, k, loops) in enumerate(sizes):
        mp, sp, edges = walk_graph(seed, m, k, loops, pins=False)
        got = graphed.optimize(mp, sp, edges)
        want = eager.optimize(mp, sp, edges)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] and graphed.lam == eager.lam
    assert len(set(captured)) == 5 and captured[-1] == captured[0]
    assert list(graphed._graphs) == captured[2:]
    after = [mm.counter(n).value for n in names]
    assert after[0] - before[0] == len(captured) == 6
    assert after[1] - before[1] == len(sizes) - len(captured)
