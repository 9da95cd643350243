"""The port's ``eval_bb_pyramid`` and ``eval_scaling`` scripts on the CPU at
small sizes: the JSON they print and write, the best block of the bound
sweep against the JAX package's on the same inputs, branch-and-bound's
score against the dense sweep's gated argmax (equal: u8 sums are exact on
both paths), and the refusals (no card; more cards than present)."""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from my_lidar_graph_slam_v2_tpu.ops import csm as jcsm
from my_lidar_graph_slam_v2_tpu.ops import pool as jpool
from my_lidar_graph_slam_v2_tpu_torch.scripts import (
    eval_bb_pyramid,
    eval_scaling,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(size=256, beams=128, thetas=16, crop=160)


def _jax_best_block(inp, thetas, crop, win=25, height=3):
    """The JAX script's best-case block: the argmax of the bound sweep of
    the level-3 pyramid of the noise map."""
    ranges, angles = jnp.asarray(inp["ranges"]), jnp.asarray(inp["angles"])
    mask = jnp.ones(ranges.shape[0], bool)
    step, t0, tmask = jcsm.theta_search_params(ranges, mask, 0.05, 0.5,
                                               thetas)
    hr, hc, valid, r0, c0 = jcsm.beam_cells(
        ranges, angles, mask, jnp.asarray(inp["pose"]), t0, step, tmask,
        0.05, jnp.asarray(inp["off"]), n_theta=thetas, crop_rows=crop,
        crop_cols=crop)
    img = jcsm.build_hit_images(hr, hc, valid, tmask, crop_rows=crop,
                                crop_cols=crop)
    prob, obs = (jnp.asarray(a) for a in inp["maps"]["noise"])
    nb = (2 * win) // (1 << height) + 1
    cs, _ = jcsm.sweep_from_hits(
        img, r0, c0, jpool.pyramid(prob, height)[-1],
        jpool.pyramid(obs, height)[-1], jnp.int32(-win), jnp.int32(-win),
        nx=nb, ny=nb, stride=1 << height, precision="split")
    best = int(jnp.argmax(cs.reshape(-1)))
    return [(best // nb) % nb, best % nb]


def test_eval_bb_pyramid_small(tmp_path, capsys):
    out_path = tmp_path / "bb.json"
    rc = eval_bb_pyramid.main([
        "--device", "cpu", "--iters", "1", "--out", str(out_path),
        *(f"--{k}={v}" for k, v in SMALL.items())])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    written = json.loads(out_path.read_text())
    assert printed == written
    for key in ("dense_sweep_ms", "bb_best_case_ms",
                "bb_matcher_noise_map_ms", "bb_matcher_peaked_map_ms",
                "bb_speedup_vs_dense_noise", "bb_speedup_vs_dense_peaked"):
        assert written[key] > 0, key
    assert written["platform"] == "cpu" and written["window_cells"] == 50
    inp = eval_bb_pyramid.build_inputs(SMALL["size"], SMALL["beams"])
    assert written["best_block"] == _jax_best_block(inp, SMALL["thetas"],
                                                    SMALL["crop"])
    for name in ("noise", "peaked"):
        m = written[f"{name}_map"]
        assert m["bb_found"] and m["dense_found"]
        assert m["bb_score"] == m["dense_gated_best_score"]
        assert 1 <= m["bb_blocks_swept"] <= m["bb_blocks"] == 49
    # the peaked map's bounds prune: fewer blocks than on the noise map
    assert (written["peaked_map"]["bb_blocks_swept"]
            < written["noise_map"]["bb_blocks_swept"])


def test_eval_scaling_small(tmp_path, capsys):
    out_path = tmp_path / "scaling.json"
    rc = eval_scaling.main(["--device", "cpu", "--devices", "1", "2",
                            "--iters", "1", "--out", str(out_path)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out_path.read_text())
    rows = printed["results"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["scaling_efficiency"] == 1.0
    for r in rows:
        assert r["workload"] == "small" and r["loop_candidates_per_s"] > 0
        assert r["loop_candidates"] == 2 * r["devices"]
        assert r["schur_lm_optimize_s"] > 0 and r["schur_lm_iterations"] >= 1
    # the LM's shards sum in f64 and round once: the same error on 1 and 2
    np.testing.assert_allclose(rows[1]["schur_lm_error"],
                               rows[0]["schur_lm_error"], rtol=1e-6)
    # each candidate is split to one device; its result does not depend on
    # the mesh: the first two candidates agree
    _, found1 = eval_scaling.bench_loop_fanout(["cpu"], small=True, iters=1)
    _, found2 = eval_scaling.bench_loop_fanout(["cpu", "cpu"], small=True,
                                               iters=1)
    assert np.array_equal(found1, found2[:2])


def test_scripts_refuse_missing_cards(capsys):
    """More cards than present is refused before any work; without CUDA
    the card default exits 2, as the port's other scripts do."""
    with pytest.raises(ValueError, match="devices asked for"):
        eval_scaling.run(torch.device("cuda"),
                         [torch.cuda.device_count() + 1])
    if not torch.cuda.is_available():
        for main in (eval_scaling.main, eval_bb_pyramid.main):
            with pytest.raises(SystemExit) as e:
                main([])
            assert e.value.code == 2
