"""The port's multi-process runtime on the CPU: two ``torch.distributed``
ranks (gloo) of ``python -m my_lidar_graph_slam_v2_tpu_torch.parallel.
worker`` run the whole pipeline with the owner-routed backend, beside a
one-rank run of the same worker (``tests/test_multihost.py``'s recipe,
without JAX).

The worker runs at its default size (the JAX worker's non-smoke shapes:
10 m office, 1.25 laps at 0.3 m): the ``--smoke`` shapes close no loop,
so the LM's collectives would never run.  Checks, fixed before the first
run: both ranks' trajectories bit for bit equal (lockstep), and equal to
the one-rank run's bit for bit (the f64 sums over ranks differ from one
rank's only in order, far below the f32 rounding); the same loop edges,
at least one; each rank asked the map cache only for maps it owns, both
ranks together for every map with a candidate; the retention invariants
of ``tests/test_multihost.py:93-116``; the sharded global map's observed
cells equal on both ranks and to the one-rank run's.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

from my_lidar_graph_slam_v2_tpu_torch.parallel.worker import check_owner_sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(port, rank, world):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "my_lidar_graph_slam_v2_tpu_torch.parallel.worker",
         "--init-method", f"tcp://localhost:{port}",
         "--world-size", str(world), "--rank", str(rank),
         "--backend", "gloo", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)


def _results(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_ranks_run_in_lockstep_and_route_to_owners():
    port2, port1 = _free_port(), _free_port()
    procs = [_spawn(port2, 0, 2), _spawn(port2, 1, 2), _spawn(port1, 0, 1)]
    r0, r1, one = _results(procs)
    assert (r0["process_id"], r1["process_id"]) == (0, 1)
    assert r0["num_processes"] == r1["num_processes"] == 2
    assert r0["global_devices"] == r1["global_devices"] == 2
    t0, t1, t = (np.array(r["trajectory"]) for r in (r0, r1, one))
    assert np.array_equal(t0, t1)
    assert np.array_equal(t0, t)
    assert r0["loop_edges"] == r1["loop_edges"] == one["loop_edges"]
    assert r0["loops"] >= 1 and r0["ate"] < 0.12
    # owner routing: each rank rasterized only its own maps, and the two
    # ranks together every map the one-rank run matched against
    for r in (r0, r1):
        assert all(m % 2 == r["process_id"] for m in r["rasterized_map_ids"])
    assert sorted(r0["rasterized_map_ids"] + r1["rasterized_map_ids"]) == \
        one["rasterized_map_ids"]
    # every backend step's collectives ran on both ranks
    assert r0["collectives"] == r1["collectives"] > 0
    assert one["dropped_rasters"] == 0
    check_owner_sharded(r0, r1)
    cells = r0["global_map_observed_cells"]
    assert cells == r1["global_map_observed_cells"] == \
        one["global_map_observed_cells"] > 0
