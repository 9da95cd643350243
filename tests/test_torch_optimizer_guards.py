"""The LM's guards against ``tests/test_optimizer.py``: uphill and NaN
steps rejected on a wildly inconsistent random graph (``:211``), and a
robust loss that ignores an outlier loop edge (``:186``), each on the
port and on the JAX package with the same inputs.

Tolerances are those of ``tests/test_torch_backend.py``'s optimizer test,
fixed there before its first run: poses within 1e-4 (m, rad), errors
rtol 1e-3, the same iteration count and lambda.

The random graph has 78 edge equations for 87 free pose values, so every
LM step's damped system is nearly singular along the exact solutions'
nine directions.  There the JAX package's f32 solve lands up to 0.025 m
from the exact f64 LM iterate, and the port's f64 solve within 4e-8 of
it (printed with -s; ROADMAP 3.16, the JAX side at fault): the port's
poses and final error are held to ``tests/test_optimizer.py``'s
independent f64 LM (``numpy_lm_oracle``) at the same tolerances, and its
iterations, lambda and initial error to the JAX package's.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.graph import loss as jloss
from my_lidar_graph_slam_v2_tpu.graph import optimizer as joptimizer
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.graph import optimizer
from tests.test_optimizer import build_loop_graph, numpy_lm_oracle
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

OPT_POSE_TOL = 1e-4
OPT_ERR_RTOL = 1e-3


def _both(solver, kind=None, scale=None):
    """The JAX optimizer and the port's (on the CPU) at the same config."""
    kw = {} if kind is None else dict(loss=jloss.LossFunction(kind, scale))
    jcfg = joptimizer.OptimizerConfig(solver=solver, **kw)
    popt = optimizer.PoseGraphOptimizer(
        reference.optimizer_config(
            dict(jcfg.__dict__, loss=jcfg.loss.__dict__)),
        device="cpu",
    )
    return joptimizer.PoseGraphOptimizer(jcfg), popt


def _assert_equal_runs(j, p, jopt, popt):
    (jm, js, jst), (pm, ps, pst) = j, p
    assert pst["iterations"] == jst["iterations"]
    assert popt.lam == pytest.approx(jopt.lam, rel=0)
    np.testing.assert_allclose(pm, jm, atol=OPT_POSE_TOL, rtol=0)
    np.testing.assert_allclose(ps, js, atol=OPT_POSE_TOL, rtol=0)
    for k in ("error", "initial_error"):
        assert pst[k] == pytest.approx(jst[k], rel=OPT_ERR_RTOL)


def _wild_graph():
    """The JAX test's graph: 6 maps and 24 scans at random poses, random
    relative poses and two loop edges (the dryrun_multichip shapes)."""
    rng = np.random.default_rng(0)
    M, N = 6, 24
    map_poses = rng.normal(0, 1.0, (M, 3))
    scan_poses = rng.normal(0, 1.0, (N, 3))
    map_idx = np.arange(N, dtype=np.int32) % M
    scan_idx = np.arange(N, dtype=np.int32)
    is_loop = np.zeros(N, np.int32)
    rel = rng.normal(0, 0.1, (N, 3)).astype(np.float32)
    info = np.tile(np.eye(3, dtype=np.float32) * 10.0, (N, 1, 1))
    map_idx = np.append(map_idx, [0, 1]).astype(np.int32)
    scan_idx = np.append(scan_idx, [N - 1, N - 2]).astype(np.int32)
    is_loop = np.append(is_loop, [1, 1]).astype(np.int32)
    rel = np.vstack([rel, rng.normal(0, 0.1, (2, 3)).astype(np.float32)])
    info = np.vstack(
        [info, np.tile(np.eye(3, dtype=np.float32) * 20.0, (2, 1, 1))])
    return map_poses, scan_poses, (map_idx, scan_idx, is_loop, rel, info)


@pytest.mark.parametrize("solver", ["schur", "dense"])
def test_lm_rejects_uphill_and_nan_steps(solver):
    mp0, sp0, edges = _wild_graph()
    jopt, popt = _both(solver)
    jm, js, jst = jopt.optimize(mp0, sp0, edges)
    mp, sp, stats = popt.optimize(mp0, sp0, edges)
    assert np.all(np.isfinite(mp)) and np.all(np.isfinite(sp)), stats
    assert stats["error"] <= stats["initial_error"] + 1e-6
    assert stats["iterations"] == jst["iterations"] >= 1
    assert popt.lam == pytest.approx(jopt.lam, rel=0)
    assert stats["initial_error"] == pytest.approx(jst["initial_error"],
                                                   rel=OPT_ERR_RTOL)
    om, osp, oerr = numpy_lm_oracle(mp0, sp0, edges, jloss.LossFunction(),
                                    iters=stats["iterations"])
    np.testing.assert_allclose(mp, om, atol=OPT_POSE_TOL, rtol=0)
    np.testing.assert_allclose(sp, osp, atol=OPT_POSE_TOL, rtol=0)
    assert stats["error"] == pytest.approx(oerr, rel=OPT_ERR_RTOL)
    # ROADMAP 3.16's figures (shown with -s)
    port_off = max(np.abs(mp - om).max(), np.abs(sp - osp).max())
    jax_off = max(np.abs(jm - om).max(), np.abs(js - osp).max())
    print(f"{solver}: from the f64 LM, port {port_off:.3g}, JAX "
          f"{jax_off:.3g}; final error port {stats['error']:.3g}, JAX "
          f"{jst['error']:.3g}")


def test_robust_loss_rejects_outlier_loop():
    """A wrong loop edge distorts the graph under a Squared loss and is
    mostly ignored under DCS; each loss's run equals the JAX one."""
    gt_m, gt_s, init_m, init_s, edges = build_loop_graph(noise=0.005, seed=3)
    map_idx, scan_idx, is_loop, rels, infos = edges
    bad_edges = (
        np.append(map_idx, 2).astype(np.int32),
        np.append(scan_idx, 40).astype(np.int32),
        np.append(is_loop, 1).astype(np.int32),
        np.vstack([rels, [4.0, -3.0, 1.5]]),
        np.vstack([infos, np.diag([400.0, 400.0, 1600.0])[None]]),
    )
    res = {}
    for kind in ("Squared", "DCS"):
        jopt, popt = _both("schur", kind, 1.0)
        j = jopt.optimize(init_m, init_s, bad_edges)
        p = popt.optimize(init_m, init_s, bad_edges)
        _assert_equal_runs(j, p, jopt, popt)
        res[kind] = np.linalg.norm(p[1][:, :2] - gt_s[:, :2], axis=1).mean()
    assert res["DCS"] < res["Squared"], res
