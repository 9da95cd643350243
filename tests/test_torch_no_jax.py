"""The port runs without JAX and without the JAX package: a fresh
interpreter with both imports blocked imports the port, runs a small
frontend through the factory with the branch-and-bound loop backend, one
branch-and-bound loop match, one batched correlative detection (the
default backend's), one detection and one solve of the multi-device
backend, one owner-routed detection in a one-rank gloo group, one grid-search and one hill-climbing match, a
correlative, grid-search and branch-and-bound match on an f32 map (the
correlative one with either sweep backend), a scatter-rasterized scan, a
counting-grid update and one pose-graph solve, imports the launcher and
its modules, builds a system from settings, reads a Carmen log with the
native parser, imports the measurement scripts and runs the head-to-head
optimizer cross-check on one committed log, and ends with neither loaded;
and no source of the port, nor its scripts, has an import statement for
either."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = "my_lidar_graph_slam_v2_tpu"


def _blocked(name):
    """jax, jaxlib and the JAX package (not the port, whose name only
    extends it with ``_torch``)."""
    return (name in ("jax", "jaxlib", JAX_PACKAGE)
            or name.startswith(("jax.", "jaxlib.", JAX_PACKAGE + ".")))


SCRIPT = r"""
import importlib.abc
import sys

JAX_PACKAGE = "my_lidar_graph_slam_v2_tpu"


def _blocked(name):
    return (name in ("jax", "jaxlib", JAX_PACKAGE)
            or name.startswith(("jax.", "jaxlib.", JAX_PACKAGE + ".")))


for name in [m for m in sys.modules if _blocked(m)]:
    del sys.modules[name]


class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if _blocked(name):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, _BlockJax())

from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.graph.optimizer import PoseGraphOptimizer
from my_lidar_graph_slam_v2_tpu_torch.loop.detector import (
    LoopDetectorBranchBound,
    LoopDetectorConfig,
    LoopDetectorEmpty,
)
from my_lidar_graph_slam_v2_tpu_torch.loop.searcher import LoopSearcherNearest
from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
    LinearSolverConfig,
    ScanMatcherLinearSolver,
)
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu_torch.pipeline.backend import LidarGraphSlamBackend
from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
    create_default_backend,
    create_default_slam,
    create_scan_matcher,
)

def fetches():
    return MetricManager.instance().counter("Device.HostFetches").value


world = synthetic.World.office(seed=1, size=8.0)
traj = synthetic.loop_trajectory(size=8.0, laps=0.2, step=0.08)
seq = synthetic.generate(world, traj, n_beams=91, max_range=8.0, seed=3)
bb = create_scan_matcher("BranchBound", device="cpu", n_theta_max=16,
                         crop_rows=96, crop_cols=96)
detector = LoopDetectorBranchBound(
    LoopDetectorConfig(beam_capacity=128, usable_range_max=8.0), bb,
    ScanMatcherLinearSolver(LinearSolverConfig(), "cpu"))
backend = LidarGraphSlamBackend(LoopSearcherNearest(), detector,
                                PoseGraphOptimizer(device="cpu"))
slam = create_default_slam(device="cpu", map_rows=256, map_cols=256,
                           beam_capacity=128, samples_per_beam=64,
                           usable_range_max=8.0, n_theta_max=32, crop=128,
                           backend=backend)
for scan in seq.scans:
    slam.process_scan(scan, scan.odom_pose)
slam.stop_backend()
assert fetches() >= 1, "no match ran"
assert len(slam.builder.local_maps) >= 2
node = slam.pose_graph.scan_nodes[-1]
q = dict(query_node=node, ref_node=node,
         local_map=slam.builder.local_map_at(0),
         local_map_node=slam.pose_graph.local_map_nodes[0])
detector.detect([q])
assert bb.matches == 1 and LoopDetectorEmpty().detect([q]) == []
snap = slam.get_pose_graph_for_optimization()
_, _, stats = backend.optimizer.optimize(*snap[2:])
assert stats["iterations"] >= 1
create_default_backend(device="cpu", sharded=False)
batched = create_default_backend(device="cpu", beam_capacity=128,
                                 n_theta_max=16, crop=96).loop_detector
f0 = fetches()
found = batched.detect([q])
# one fetch for the batch, one per found candidate's final match
assert fetches() - f0 == 1 + len(found), "the batched detector did not run"

import socket
import torch.distributed as tdist
from my_lidar_graph_slam_v2_tpu_torch.parallel import (
    distributed, mesh, multihost, worker)
from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
    create_distributed_backend)

small = dict(beam_capacity=128, n_theta_max=16, crop=96)
dist_backend = create_distributed_backend(mesh.make_mesh(["cpu", "cpu"]),
                                          **small)
f0 = fetches()
found = dist_backend.loop_detector.detect([q])
assert fetches() - f0 == 1 + len(found)
assert dist_backend.optimizer.optimize(*snap[2:])[2]["iterations"] >= 1
sock = socket.socket()
sock.bind(("localhost", 0))
port = sock.getsockname()[1]
sock.close()
multihost.init_multihost(f"tcp://localhost:{port}", 1, 0, backend="gloo")
mh = multihost.create_multihost_backend(mesh.make_mesh(["cpu"]),
                                        **small)
mh.loop_detector.detect([q])
assert mh.loop_detector.ranks.calls == 1
tdist.destroy_process_group()

import numpy as np
from my_lidar_graph_slam_v2_tpu_torch.grid import geometry
from my_lidar_graph_slam_v2_tpu_torch.grid.counted import GridCounted
from my_lidar_graph_slam_v2_tpu_torch.loop.detector import scan_to_arrays
from my_lidar_graph_slam_v2_tpu_torch.matching.types import ScanMatchingQuery
from my_lidar_graph_slam_v2_tpu_torch.utils import oracle

gs = create_scan_matcher("GridSearch", device="cpu", range_x=0.3,
                         range_y=0.3, range_theta=0.1, step_theta=0.02,
                         crop_rows=96, crop_cols=96)
hc = create_scan_matcher("HillClimbing", device="cpu")
raster = detector.map_cache.raster(slam.builder.local_map_at(0))
arrays = scan_to_arrays(node.scan_data, 128, "cpu")
gs_fetches = []
for m in (gs, hc):
    f0 = fetches()
    m.optimize_pose(ScanMatchingQuery(raster, arrays, np.zeros(3)))
    gs_fetches += [fetches() - f0] if m is gs else []
assert gs_fetches == [1] and hc.matches == 1

import torch
from my_lidar_graph_slam_v2_tpu_torch.matching.correlative import (
    CorrelativeConfig, ScanMatcherCorrelative)
from my_lidar_graph_slam_v2_tpu_torch.matching.types import MapRaster
from my_lidar_graph_slam_v2_tpu_torch.ops import csm, rasterize

f32_raster = MapRaster(raster.prob.float() / 255.0, raster.observed,
                       raster.resolution, raster.offset_xy)
f32_query = ScanMatchingQuery(f32_raster, arrays, np.zeros(3))
for backend in ("matmul", "gather"):
    ScanMatcherCorrelative(CorrelativeConfig(
        n_theta_max=16, crop_rows=96, crop_cols=96, precision="highest",
        sweep_backend=backend), "cpu").optimize_pose(f32_query)
f0 = fetches()
gs.optimize_pose(f32_query)
gs_fetches.append(fetches() - f0)
bb.optimize_pose(f32_query)
assert sum(gs_fetches) == 2 and bb.matches == 2
delta = rasterize.scan_delta((64, 64), arrays.ranges.new_zeros(2),
                             torch.ones(3, 2), torch.ones(3, dtype=torch.bool),
                             0.05, torch.full((2,), -1.6), 0.5, -0.2,
                             num_samples=32, backend="scatter")
assert float(delta.abs().sum()) > 0
counted = GridCounted(8, 8, "cpu")
counted.update([1, 2, 9], [3, 4, 0], [True, False, True])
assert int(counted.counts.sum()) == 2

from my_lidar_graph_slam_v2_tpu_torch.config import settings
from my_lidar_graph_slam_v2_tpu_torch.io import carmen, graph_plot, map_saver
from my_lidar_graph_slam_v2_tpu_torch.network import slam_client
from my_lidar_graph_slam_v2_tpu_torch.pipeline import checkpoint, launcher

settings.create_slam_from_settings({}, map_rows=128, map_cols=128,
                                   n_theta_max=16, crop=96, device="cpu")
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    carmen.write_carmen_log(seq.scans[:3], tmp + "/s.log")
    assert len(carmen.read_carmen_log(tmp + "/s.log", native=True)) == 3

from pathlib import Path
from my_lidar_graph_slam_v2_tpu_torch.scripts import (
    bench_csm, bench_e2e, common, eval_ate, eval_bb_pyramid, eval_scaling,
    eval_scaling_pipeline, head_to_head, metric_diff)

h2h = Path("h2h")
x = head_to_head.optimizer_cross_check(h2h / "ref_synth7.posegraph.json",
                                       h2h / "ref_synth7.metric.json")
assert abs(x["our_error_on_ref_solution"] - x["ref_final_error"]) < 1e-4
assert len(bench_e2e.build_sequence(4).scans) > 10
assert len(eval_ate.configs()) == 4 and metric_diff.SECTIONS
assert bench_csm.pinned_cpu_baseline()["cpu_rate"] > 0
assert common.card(common.script_device("cpu", "t"))["platform"] == "cpu"
assert eval_bb_pyramid.build_inputs(64, 16)["maps"]["peaked"][0].max() == 240
assert eval_scaling.schur_graph()[2][0].size == 1024 + 128
assert callable(eval_scaling_pipeline.run_config)
assert not [m for m in sys.modules if _blocked(m)]
print("ok", slam.process_count)
"""


def test_port_imports_and_matches_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # one torch thread, as tests/torch_threads.py explains
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_sources_do_not_import_jax_or_the_jax_package():
    """Every import statement in the port's package, in its scripts and in
    the card's tests with the helpers they import (``tests/torch_*.py``),
    read from the source (an import inside a function counts too)."""
    files = sorted((ROOT / (JAX_PACKAGE + "_torch")).rglob("*.py"))
    files += [ROOT / n for n in ("chip_smoke.py", "sweep_ab.py",
                                 "span_audit.py")]
    files += sorted((ROOT / "tests").glob("torch_*.py"))
    files += sorted((ROOT / "tests").glob("test_torch_cuda*.py"))
    assert len(files) > 40
    found = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                      for n in names if _blocked(n)]
    assert not found, found
