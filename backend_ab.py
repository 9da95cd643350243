#!/usr/bin/env python3
"""Host times of the default loop-closing backend of one source tree, so
two versions can be compared on one card in one command:

    python3 backend_ab.py OLD_TREE && python3 backend_ab.py . && \
        python3 backend_ab.py . && python3 backend_ab.py OLD_TREE

``TREE`` is the root of a checkout (a ``git archive`` of another commit
unpacked into a directory that ``.gitignore`` lists, or ``.``).  The
script drives config #3's world (seed 11, 1.3 laps, 70 keyframes) through
that tree's ``create_default_slam`` with ``create_default_backend()`` (the
batched correlative loop detector and the Schur LM) on ``cuda:0``, as
``chip_smoke.py``'s phase 7 does: one warm-up run, then ``RUNS`` timed
runs, each ``detect``, LM call and backend step timed by host clock
(their result fetches synchronize; nothing is fenced).  It prints one JSON
line with the medians over all timed runs, the sweep launches, the loop
edges and a hash of the trajectory, so the trees' results can be seen to
agree.  The harness comes from this checkout's ``chip_smoke.py``; the
world is built with the tree's own synthetic module.

Imports nothing of JAX.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import sys
from pathlib import Path

import torch

RUNS = 3


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("backend_ab: CUDA is not available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(here))
    import chip_smoke

    sys.path.insert(0, str(tree))
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    if not Path(synthetic.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {synthetic.__file__}, not {tree}'s")
    device = torch.device("cuda", 0)
    label = os.path.relpath(tree, here)
    print(f"device: {chip_smoke._nvidia_smi()}; tree {label}", flush=True)
    seq = synthetic.generate(  # config #3's world
        synthetic.World.office(seed=11, size=12.0),
        synthetic.loop_trajectory(size=12.0, laps=1.3, step=0.08),
        n_beams=181, max_range=12.0, range_noise=0.01,
        odom_noise=(0.05, 0.02), seed=12)
    kw = dict(make_slam=chip_smoke.default_loop_slam)
    chip_smoke.run_loop_slice(device, seq,
                              stages=chip_smoke._logged_detects([]), **kw)
    detect_ms, lm_ms, step_ms, runs = [], [], [], []
    for _ in range(RUNS):
        calls = []
        csm_cuda.LAUNCHES = 0
        run = chip_smoke.run_loop_slice(
            device, seq, stages=chip_smoke._logged_detects(calls), **kw)
        detect_ms += [c["ms"] for c in calls if c["n"]]
        lm_ms += run["stages"]["LM"][1]
        step_ms += run["stages"]["backend step"][1]
        runs.append(dict(
            keyframes=len(run["est"]), loop_edges=len(run["loops"]),
            sweep_launches=csm_cuda.LAUNCHES, wall_s=run["wall"],
            trajectory_sha256=hashlib.sha256(
                run["est"].tobytes()).hexdigest()[:16]))
    print("backend_ab " + json.dumps(dict(
        tree=label, runs=runs, detects=len(detect_ms), lm_calls=len(lm_ms),
        detect_ms_median=statistics.median(detect_ms),
        lm_ms_median=statistics.median(lm_ms),
        backend_step_ms_median=statistics.median(step_ms))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
