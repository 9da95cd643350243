"""The port against the reference C++ binary's recorded runs in ``h2h/``
(the logs synth7 and synth11 of ``h2h/results_h2h.json``, and synth3, the
997-keyframe log of ``h2h/results_h2h_tpu.json``).

- synth7 here and synth11 in ``tests/test_torch_h2h_synth11.py`` (one
  log per file, so the test workers run them side by side) go through
  ``scripts/head_to_head.py:head_to_head`` (the port's launcher in a
  subprocess, ``--device cpu``) with the binary's settings, scored
  against the logs' ground truth with the port's ``evaluate``: nodes and
  loop edges equal to the binary's, ATE at or below the binary's, and ATE
  at most ``JAX_ATE_SLACK`` above the JAX package's artifact
  (``h2h/tpu_synth*.posegraph.json``).  The slack was fixed before the
  first run: the launcher's backend is threaded, so the moments at which
  loop closures land, and with them the final poses, may differ between
  runs.  Keyframes cannot (the gate reads odometry alone).
- The optimizer cross-check on all three logs: the port's f64 robust
  total error on the binary's final graph within 1e-4 of the binary's
  recorded FinalError (which it prints with 6 decimals), the port's LM
  re-optimization of that graph not below it by more than 1e-4, and the
  error within 1e-6 of the JAX package's own f64 value recorded in the
  results files.
- The metric diff: the port's synth7 metrics JSON has every series of the
  binary's but those in ``KNOWN_GAPS`` (none), each of which the JAX
  artifact ``h2h/tpu_synth7.metric.json`` lacks too.
"""
import json
from pathlib import Path

import pytest

from my_lidar_graph_slam_v2_tpu_torch.scripts import head_to_head, metric_diff

ROOT = Path(__file__).resolve().parent.parent
H2H = ROOT / "h2h"
JAX_ATE_SLACK = 0.005
KNOWN_GAPS = set()


def run_log(seed, workdir):
    """synth{seed} through ``head_to_head.head_to_head`` on the CPU, one
    torch thread (the test workers share the cores); returns its result
    and the port's output prefix."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        r = head_to_head.head_to_head(seed, workdir, device="cpu")
    assert r["ours"]["device_report"] is None  # the card's report
    return r, Path(workdir) / f"torch_synth{seed}"


def check_against_the_binary(r):
    ours, ref, jax_art = r["ours"], r["reference"], r["jax_artifact"]
    assert ours["nodes"] == ref["nodes"] == jax_art["nodes"]
    assert ours["loop_edges"] == ref["loop_edges"]
    assert ours["ate_m"] <= ref["ate_m"]
    assert ours["ate_m"] <= jax_art["ate_m"] + JAX_ATE_SLACK, (ours, jax_art)


@pytest.fixture(scope="module")
def synth7(tmp_path_factory):
    return run_log(7, tmp_path_factory.mktemp("h2h"))


def test_synth7_meets_the_reference_binary(synth7):
    r, _ = synth7
    assert (r["reference"]["nodes"], r["reference"]["loop_edges"]) == (91, 8)
    check_against_the_binary(r)


def _missing(ref_doc, ours_doc):
    return {name for section in metric_diff.SECTIONS
            for name in (metric_diff.names(ref_doc, section)
                         - metric_diff.names(ours_doc, section))}


def test_synth7_metrics_have_the_reference_series(synth7):
    _, prefix = synth7
    ref = json.loads((H2H / "ref_synth7.metric.json").read_text())
    ours = json.loads(Path(f"{prefix}.metric.json").read_text())
    jax_art = json.loads((H2H / "tpu_synth7.metric.json").read_text())
    missing = _missing(ref, ours)
    assert missing <= KNOWN_GAPS, sorted(missing - KNOWN_GAPS)
    assert KNOWN_GAPS <= _missing(ref, jax_art)
    assert len(metric_diff.names(ref, "ValueSequences")) > 90
    assert metric_diff.main([str(H2H / "ref_synth7.metric.json"),
                             f"{prefix}.metric.json"]) == 0


def _jax_cross_check(seed):
    """The JAX package's recorded cross-check of log ``seed``."""
    name = "results_h2h_tpu.json" if seed == 3 else "results_h2h.json"
    results = json.loads((H2H / name).read_text())["results"]
    return next(r for r in results if r["seed"] == seed)[
        "optimizer_cross_check"]


@pytest.mark.parametrize("seed", [7, 11, 3])
def test_optimizer_cross_check(seed, synth7):
    """The optimizer cross-check of each log (synth7's from its run)."""
    x = (synth7[0]["optimizer_cross_check"] if seed == 7
         else head_to_head.optimizer_cross_check(
             H2H / f"ref_synth{seed}.posegraph.json",
             H2H / f"ref_synth{seed}.metric.json"))
    jx = _jax_cross_check(seed)
    assert x["ref_final_error"] == jx["ref_final_error"]
    assert x["ref_initial_error"] == jx["ref_initial_error"]
    assert abs(x["our_error_on_ref_solution"] - x["ref_final_error"]) < 1e-4
    assert x["our_reoptimized_error"] >= x["ref_final_error"] - 1e-4
    assert abs(x["our_error_on_ref_solution"]
               - jx["our_error_on_ref_solution"]) < 1e-6
