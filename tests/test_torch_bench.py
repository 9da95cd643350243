"""The port's measurement scripts against the JAX package's: the CSM
benchmark's workload, batched core and C++ baseline (``bench.py``), the
end-to-end sequence and run (``scripts/bench_e2e.py``) and config #1 of
``scripts/eval_ate.py``.

Tolerances, fixed before the first run:
- scans, beams, masks, poses, offsets, observed masks and the e2e
  sequence: equal (the same NumPy code on the same seeds);
- the workload's u8 rasters: equal but in at most ``RASTER_CELLS`` cells
  of a 1024 x 1024 map.  A ray sample is ``floor(f32 / res)`` of
  ``sensor + d * t``, which XLA and PyTorch may round an ulp apart where a
  sample sits on a cell edge (``tests/test_torch_ops.py``); such a sample
  adds or drops one miss in one cell;
- the batched core on the same rasters (the JAX workload's): scores and
  known rates equal (integer sums of u8 levels over the same beams);
  poses within 1e-4 of the JAX core's (the correlative-core tolerance of
  ``tests/test_torch_matcher.py``; the winner's pose is an f32 sum in
  another order); counts and flags equal; costs and covariances within
  rtol 1e-3;
- the C++ baseline: the same pose and score (the same source, built with
  the same flags);
- eval_ate config #1: the same keyframes (the gate reads odometry alone),
  ATE within 0.005 m of the JAX run's.
"""
import ast
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.matching.correlative import (
    CorrelativeConfig as JCorrelativeConfig,
    _correlative_core as j_correlative_core,
)
from my_lidar_graph_slam_v2_tpu.native import (
    cpu_correlative_search as j_cpu_correlative_search,
    cpu_precompute_coarse as j_cpu_precompute_coarse,
)
from my_lidar_graph_slam_v2_tpu_torch import native
from my_lidar_graph_slam_v2_tpu_torch.matching.types import MapRaster, ScanArrays
from my_lidar_graph_slam_v2_tpu_torch.scripts import (
    bench_csm,
    bench_e2e,
    eval_ate,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
RASTER_CELLS = 10
POSE_TOL = 1e-4


def _load(name, path):
    """A script of the JAX package, imported from its file."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jbench():
    return _load("jax_bench", ROOT / "bench.py")


@pytest.fixture(scope="module")
def workloads(jbench):
    return jbench.build_workload(), bench_csm.build_workload()


def _port_cases(jcases):
    """The JAX workload's arrays as the port's cases."""
    out = []
    for raster, arrays, pose in jcases:
        out.append((
            MapRaster(torch.as_tensor(np.array(raster.prob)),
                      torch.as_tensor(np.array(raster.observed)),
                      raster.resolution, np.asarray(raster.offset_xy)),
            ScanArrays(*(torch.as_tensor(np.array(a)) for a in
                         (arrays.ranges, arrays.angles, arrays.mask)),
                       np.zeros(3), arrays.num_valid),
            np.asarray(pose)))
    return out


def test_workload_equals_bench(workloads):
    jcases, pcases = workloads
    assert len(jcases) == len(pcases) == 4
    for (jr, ja, jp), (pr, pa, pp) in zip(jcases, pcases):
        jprob, pprob = np.asarray(jr.prob), pr.prob.numpy()
        assert pprob.dtype == jprob.dtype == np.uint8
        assert pprob.shape == (1024, 1024)
        assert (pprob != jprob).sum() <= RASTER_CELLS
        np.testing.assert_array_equal(pr.observed.numpy(),
                                      np.asarray(jr.observed))
        np.testing.assert_array_equal(np.asarray(pr.offset_xy),
                                      np.asarray(jr.offset_xy))
        for k in ("ranges", "angles", "mask"):
            np.testing.assert_array_equal(getattr(pa, k).numpy(),
                                          np.asarray(getattr(ja, k)))
        assert pa.num_valid == ja.num_valid > 100
        np.testing.assert_array_equal(pp, jp)


def test_batched_core_matches_jax_vmap(workloads):
    """The benchmark's batch of 8 through the port's batched core (plain
    sweep on the CPU) against the JAX core under ``jax.vmap``."""
    jcases, _ = workloads
    jcfg = JCorrelativeConfig(n_theta_max=176, crop_rows=320, crop_cols=320)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(
        bench_csm.FRONTEND_WINDOW)

    def single(prob, observed, ranges, angles, mask, sensor_pose, offset):
        return j_correlative_core(
            jcfg, prob, observed, None, None, ranges, angles, mask,
            sensor_pose, offset, jnp.float32(0.0), jnp.float32(0.0))

    sel = [jcases[i % 4] for i in range(8)]
    j = jax.device_get(jax.jit(jax.vmap(single))(
        jnp.stack([c[0].prob for c in sel]),
        jnp.stack([c[0].observed for c in sel]),
        jnp.stack([c[1].ranges for c in sel]),
        jnp.stack([c[1].angles for c in sel]),
        jnp.stack([c[1].mask for c in sel]),
        jnp.asarray(np.stack([c[2] for c in sel]).astype(np.float32)),
        jnp.asarray(np.stack([np.asarray(c[0].offset_xy)
                              for c in sel]).astype(np.float32)),
    ))
    _, _, p = bench_csm.bench_device(_port_cases(jcases), iters=1, batch=8,
                                     device="cpu", with_stages=False)
    j = [np.asarray(x, np.float64) for x in j]
    p = [x.numpy().astype(np.float64) for x in p]
    pose, score, known, found, ncost, cov, n_proc, n_total, exact = range(9)
    np.testing.assert_allclose(p[pose], j[pose], rtol=0, atol=POSE_TOL)
    for k in (score, known, found, n_proc, n_total, exact):
        np.testing.assert_array_equal(p[k], j[k], err_msg=str(k))
    np.testing.assert_allclose(p[ncost], j[ncost], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(p[cov], j[cov], rtol=1e-3,
                               atol=1e-3 * np.abs(j[cov]).max())
    assert p[found].all() and p[exact].all()


def test_cpu_baseline_equals_the_jax_loader(workloads):
    """One case through both loaders of ``csm_baseline.cpp``; the port's
    library lands under ``build/native/``."""
    _, pcases = workloads
    raster, arrays, pose = pcases[0]
    fine = raster.prob.numpy().astype(np.float32) / np.float32(255.0)
    n = arrays.num_valid
    ranges = arrays.ranges.numpy()[:n]
    angles = arrays.angles.numpy()[:n]
    tt = 0.05 / ranges.max()
    step = float(np.arccos(1.0 - 0.5 * tt * tt))
    win_t = int(np.ceil(0.25 / step))
    off = np.asarray(raster.offset_xy)
    coarse = native.cpu_precompute_coarse(fine, 5)
    np.testing.assert_array_equal(coarse, j_cpu_precompute_coarse(fine, 5))
    args = (fine, coarse, ranges, angles, pose, 0.05, off, 3, 3, win_t,
            step, 5)
    best, score = native.cpu_correlative_search(*args)
    j_best, j_score = j_cpu_correlative_search(*args)
    np.testing.assert_array_equal(best, j_best)
    assert score == j_score > 0.5
    lib = native.library_path("csm_baseline", native.BASELINE_FLAGS)
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert not list(native.SRC_DIR.glob("*.so"))


@pytest.fixture(scope="module")
def jbench_e2e():
    return _load("jax_bench_e2e", ROOT / "scripts" / "bench_e2e.py")


def test_sequence_equals_bench_e2e(jbench_e2e):
    j = jbench_e2e.build_sequence(120)
    p = bench_e2e.build_sequence(120)
    np.testing.assert_array_equal(p.ground_truth, j.ground_truth)
    assert len(p.scans) == len(j.scans) > 600
    for a, b in zip(p.scans, j.scans):
        for k in ("ranges", "angles", "odom_pose", "time_stamp",
                  "max_range", "relative_sensor_pose"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _jax_result_keys():
    """The keys of the result dict of ``scripts/bench_e2e.py:run``, read
    from its source."""
    tree = ast.parse((ROOT / "scripts" / "bench_e2e.py").read_text())
    run = next(n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "run")
    for node in ast.walk(run):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "result"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in scripts/bench_e2e.py:run")


def test_short_run_has_the_jax_result_keys():
    keys = _jax_result_keys()
    assert "jit_cache_sizes" in keys and len(keys) > 20
    r = bench_e2e.run(max_scans=150, threaded=False, progress=False,
                      device="cpu")
    assert set(r) == keys - {"jit_cache_sizes"} | {"peak_device_mb"}
    assert r["platform"] == "cpu" and r["peak_device_mb"] is None
    assert r["scans"] == 150 and r["keyframes"] >= 20
    assert r["ate_rmse_m"] < r["ate_odometry_m"]
    assert r["stages"]["Frontend.ProcessTime"]["n"] == 150


def test_eval_ate_config1_matches_jax():
    jeval = _load("jax_eval_ate", ROOT / "scripts" / "eval_ate.py")
    kw = dict(backend_kind=None, laps=0.35, odom_noise=(0.03, 0.01))
    j = jeval.run_config("1-odometry-only-csm", **kw)
    name, pkw = eval_ate.configs(quick=True)[0]
    assert name == "1-odometry-only-csm" and pkw == kw
    p = eval_ate.run_config(name, device="cpu", **pkw)
    assert set(p) == set(j)
    for k in ("config", "keyframes", "scans", "ate_odometry_m",
              "loop_edges"):
        assert p[k] == j[k], k
    assert abs(p["ate_m"] - j["ate_m"]) <= 0.005
    assert p["ate_m"] < p["ate_odometry_m"]


@pytest.mark.parametrize("name", ["bench_csm", "bench_e2e", "eval_ate",
                                  "head_to_head"])
def test_scripts_default_to_the_card(name):
    """Each script runs on ``--device cuda`` unless asked for the CPU, and
    without a card it exits 2 before any work."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    module = importlib.import_module(
        f"my_lidar_graph_slam_v2_tpu_torch.scripts.{name}")
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code == 2
