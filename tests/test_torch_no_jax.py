"""The port runs without JAX: a fresh interpreter with JAX import blocked
imports the port, runs one small frontend match through the factory, and
ends with no ``jax`` module loaded."""
import os
import subprocess
import sys

SCRIPT = r"""
import importlib.abc
import sys

for name in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[name]


class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, _BlockJax())

from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import create_default_slam

world = synthetic.World.office(seed=1, size=8.0)
traj = synthetic.loop_trajectory(size=8.0, laps=0.06, step=0.08)
seq = synthetic.generate(world, traj, n_beams=91, max_range=8.0, seed=3)
slam = create_default_slam(device="cpu", map_rows=256, map_cols=256,
                           beam_capacity=128, samples_per_beam=64,
                           usable_range_max=8.0, n_theta_max=32, crop=128)
for scan in seq.scans:
    slam.process_scan(scan, scan.odom_pose)
assert slam.frontend.scan_matcher.host_fetches >= 1, "no match ran"
assert "jax" not in sys.modules
print("ok", slam.process_count)
"""


def test_port_imports_and_matches_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
