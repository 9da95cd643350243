"""The port's I/O surface against the JAX suite's checks of it: the
visualization client's wire format (``tests/test_network.py:19``), the
Carmen writer's uniform-geometry contract, the SVG live view and the
extended map-saver outputs (``tests/test_io_config.py:89``, ``:298``,
``:337``).  Each feeds the same inputs to both packages and requires the
same bytes, the same text or the same error.
"""
import dataclasses
import socket
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from my_lidar_graph_slam_v2_tpu.datasets import synthetic as jsynthetic
from my_lidar_graph_slam_v2_tpu.graph import pose_graph as jpose_graph
from my_lidar_graph_slam_v2_tpu.io import carmen as jcarmen
from my_lidar_graph_slam_v2_tpu.io import graph_plot as jgraph_plot
from my_lidar_graph_slam_v2_tpu.io import map_saver as jmap_saver
from my_lidar_graph_slam_v2_tpu.network import slam_client as jslam_client
from my_lidar_graph_slam_v2_tpu.pipeline.factory import create_default_slam
from my_lidar_graph_slam_v2_tpu.sensor.data import ScanData as JScanData
from my_lidar_graph_slam_v2_tpu_torch import reference
from my_lidar_graph_slam_v2_tpu_torch.graph import pose_graph
from my_lidar_graph_slam_v2_tpu_torch.io import carmen, graph_plot, map_saver
from my_lidar_graph_slam_v2_tpu_torch.matching.types import MapRaster
from my_lidar_graph_slam_v2_tpu_torch.network import slam_client
from my_lidar_graph_slam_v2_tpu_torch.sensor.data import ScanData
from tests.test_io_config import write_synthetic_carmen
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---- the client's wire format (tests/test_network.py:19) -------------------
def _received(client_module, scan_cls, messages):
    """Every byte one client sends for ``messages`` to a local socket."""
    received = bytearray()
    server = socket.socket()
    server.bind(("127.0.0.1", 0))
    server.listen(1)

    def serve():
        conn, _ = server.accept()
        while data := conn.recv(65536):
            received.extend(data)
        conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    c = client_module.SlamClient("127.0.0.1", server.getsockname()[1])
    assert c.connect()
    for kind, args in messages:
        if kind == "params":
            assert c.send_grid_map_params(client_module.GridMapParams(**args))
        elif kind == "poses":
            assert c.send_pose_array(*args)
        else:
            assert c.send_scan(scan_cls(*args))
    assert c.disconnect()
    th.join(timeout=5)
    server.close()
    assert not th.is_alive()
    return bytes(received)


def test_client_wire_format_equals_reference():
    rng = np.random.default_rng(19)
    scan = ("S", 3.0, np.zeros(3), np.zeros(3), np.array([0.08, 0.0, 0.0]),
            0.01, 20.0, -1.5, 1.5, np.linspace(-1.5, 1.5, 5), np.full(5, 2.0))
    wide = ("S", 7.25, np.zeros(3), np.zeros(3), np.array([0.1, -0.02, 0.3]),
            0.1, 30.0, -np.pi, np.pi, np.linspace(-np.pi, np.pi, 361),
            rng.uniform(0.1, 30.0, 361))
    messages = [
        ("params", {}),
        ("poses", ([1.5, 2.5], np.array([[1.0, 2.0, 0.1], [1.1, 2.1, 0.2]]))),
        ("scan", scan),
        ("params", dict(resolution=0.1, block_size=8, subpixel_scale=10,
                        probability_hit=0.7, probability_miss=0.4)),
        ("poses", (rng.uniform(0, 100, 50), rng.normal(0, 5, (50, 3)))),
        ("poses", ([], np.zeros((0, 3)))),
        ("scan", wide),
    ]
    got = _received(slam_client, ScanData, messages)
    ref = _received(jslam_client, JScanData, messages)
    assert got == ref
    assert len(got) > 2 * 361 * 8  # the wide scan's ranges and angles
    assert got[:4] == slam_client.MSG_GRID_MAP_PARAMS.to_bytes(4, "big")
    assert got[-4:] == slam_client.MSG_STOP.to_bytes(4, "big")


def test_client_refuses_to_send_unconnected():
    c = slam_client.SlamClient("127.0.0.1", 1)
    assert not c.send_pose_array([0.0], np.zeros((1, 3)))
    assert c.disconnect()


# ---- Carmen writer (tests/test_io_config.py:89) ----------------------------
def _bad_sequences(scans):
    bad = list(scans)
    bad[2] = dataclasses.replace(bad[2], max_range=bad[2].max_range + 5.0)
    bad2 = list(scans)
    bad2[1] = dataclasses.replace(bad2[1], angles=bad2[1].angles[:-2],
                                  ranges=bad2[1].ranges[:-2])
    return dict(range=bad, beams=bad2)


@pytest.mark.parametrize("bad", ["range", "beams"])
def test_carmen_writer_rejects_heterogeneous_geometry(tmp_path, bad):
    p = tmp_path / "uniform.log"
    write_synthetic_carmen(p)
    runs = {}
    for name, module in (("port", carmen), ("jax", jcarmen)):
        scans = [r for r in module.read_carmen_log(str(p))
                 if isinstance(r, (ScanData, JScanData))]
        assert len(scans) == 5
        module.write_carmen_log(scans, str(tmp_path / f"{name}.log"))
        with pytest.raises(ValueError, match="uniform laser geometry") as e:
            module.write_carmen_log(_bad_sequences(scans)[bad],
                                    str(tmp_path / f"{name}-bad.log"))
        runs[name] = str(e.value)
        assert not (tmp_path / f"{name}-bad.log").exists()
    assert runs["port"] == runs["jax"]
    assert (tmp_path / "port.log").read_bytes().splitlines()[1:] == \
        (tmp_path / "jax.log").read_bytes().splitlines()[1:]


# ---- SVG live view (tests/test_io_config.py:298) ---------------------------
def _graph(pg_module, n=4, seed=0):
    rng = np.random.default_rng(seed)
    pg = pg_module.PoseGraph()
    for m in range(2):
        pg.local_map_nodes.append(
            pg_module.LocalMapNode(m, np.array([2.0 * m, -0.5 * m, 0.1 * m])))
    for i in range(n):
        pose = np.array([i * 1.0, 0.1 * i, 0.0]) + rng.normal(0, 0.05, 3)
        pg.scan_nodes.append(pg_module.ScanNode(i, i % 2, np.zeros(3), pose))
        pg.edges.append(pg_module.PoseGraphEdge(
            i % 2, i, 0, pg_module.CONSTRAINT_ODOMETRY, np.zeros(3),
            np.eye(3)))
    pg.edges.append(pg_module.PoseGraphEdge(
        0, n - 1, 1, pg_module.CONSTRAINT_LOOP, np.zeros(3), np.eye(3)))
    return pg


@pytest.mark.parametrize("n", [0, 1, 4, 40])
def test_pose_graph_svg_equals_reference(tmp_path, n):
    if n == 0:
        pg, jpg = pose_graph.PoseGraph(), jpose_graph.PoseGraph()
    else:
        pg, jpg = _graph(pose_graph, n), _graph(jpose_graph, n)
    svg = graph_plot.pose_graph_svg(pg)
    assert svg.startswith("<svg")
    assert svg == jgraph_plot.pose_graph_svg(jpg)
    graph_plot.draw_pose_graph(pg, str(tmp_path / "p.svg"))
    jgraph_plot.draw_pose_graph(jpg, str(tmp_path / "j.svg"))
    assert (tmp_path / "p.svg").read_text() == \
        (tmp_path / "j.svg").read_text()
    if n:
        assert graph_plot.ODOMETRY_COLOR in svg
        assert graph_plot.LOOP_COLOR in svg
        assert "polyline" in svg


# ---- extended map-saver outputs (tests/test_io_config.py:337) --------------
@pytest.fixture(scope="module")
def jax_run():
    """The JAX test's run, ten scans of an 8 m office through the JAX
    package's default slam, with a local map every 0.6 m so that it ends
    with several; both savers then write its maps, poses and last scan."""
    world = jsynthetic.World.office(seed=5, size=8.0)
    traj = jsynthetic.loop_trajectory(size=8.0, laps=0.15, step=0.3)
    seq = jsynthetic.generate(world, traj, n_beams=91, max_range=8.0, seed=5)
    slam = create_default_slam(
        map_rows=512, map_cols=512, beam_capacity=128, samples_per_beam=160,
        usable_range_max=8.0, n_theta_max=32, crop=256,
        builder_overrides=dict(travel_dist_threshold=0.6))
    last = None
    for scan in seq.scans[:10]:
        if slam.process_scan(scan, scan.odom_pose):
            last = scan
    return slam, last


def _same_files(tmp_path, pattern):
    port = sorted(tmp_path.glob(f"p{pattern}"))
    assert port
    for f in port:
        ref = tmp_path / ("j" + f.name[1:])
        assert f.read_bytes() == ref.read_bytes(), f.name


def test_save_map_and_scan_equals_reference(tmp_path, jax_run):
    slam, last = jax_run
    pose, jraster = slam.get_latest_map()
    traj = slam.get_trajectory()
    raster = MapRaster(torch.as_tensor(np.array(jraster.prob)),
                       torch.as_tensor(np.array(jraster.observed)),
                       jraster.resolution, np.asarray(jraster.offset_xy))
    scan = ScanData(*(getattr(last, f.name)
                      for f in dataclasses.fields(JScanData)))
    map_saver.save_map_and_scan(raster, str(tmp_path / "pm"), pose,
                                scan_global_pose=traj[-1], scan=scan,
                                trajectory=traj)
    jmap_saver.save_map_and_scan(jraster, str(tmp_path / "jm"), pose,
                                 scan_global_pose=traj[-1], scan=last,
                                 trajectory=traj)
    _same_files(tmp_path, "m.*")
    # with neither scan nor trajectory: the map alone
    map_saver.save_map_and_scan(raster, str(tmp_path / "pn"), pose)
    jmap_saver.save_map_and_scan(jraster, str(tmp_path / "jn"), pose)
    _same_files(tmp_path, "n.*")


def test_save_local_maps_equals_reference(tmp_path, jax_run):
    """One PNG and JSON per local map, live (f32 log-odds) or compacted
    (u8), from the same map state in both packages."""
    slam, _ = jax_run
    jb, jpg = slam.builder, slam.pose_graph
    assert len(jb.local_maps) >= 2
    jb.local_maps[0].compact()
    pmaps = []
    for lm in jb.local_maps:
        state = (dict(prob_q=np.asarray(lm.prob_q)) if lm.compacted
                 else dict(logodds=np.asarray(lm.logodds)))
        pmaps.append(reference.local_map(
            lm.local_map_id, lm.offset_xy, "cpu",
            observed=np.asarray(lm.observed), finished=lm.finished, **state))
    builder = SimpleNamespace(
        cfg=SimpleNamespace(resolution=jb.cfg.resolution), local_maps=pmaps)
    pg = pose_graph.PoseGraph()
    pg.local_map_nodes.extend(
        pose_graph.LocalMapNode(n.local_map_id, n.global_pose.copy(),
                                n.finished)
        for n in jpg.local_map_nodes)
    traj = slam.get_trajectory()
    assert map_saver.save_local_maps(builder, pg, str(tmp_path / "pl"),
                                     trajectory=traj)
    jmap_saver.save_local_maps(jb, jpg, str(tmp_path / "jl"), trajectory=traj)
    _same_files(tmp_path, "l.local-map-*")
    assert len(list(tmp_path.glob("pl.local-map-*.png"))) == len(pmaps)
