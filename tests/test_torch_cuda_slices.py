"""The port's systems on the card against the same systems on the CPU: the
frontend slices, the loop slices of every detector, the launcher, the
multi-device layer and the matchers on f32 maps, on the courses of
``torch_card_cases``, each with its kernels' launch contracts.  They
import no JAX and skip without a GPU.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_slices.py -q

A run that another test compares against (the default frontend, the
serial and the batched loop slices) is made once per module, in a
fixture.  The tolerances were fixed before the first run on the card.
"""
import contextlib
import json
import os
import socket
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda
from torch_card_cases import (
    GRID_SEARCH_SETTINGS,
    HILL_CLIMBING_SETTINGS,
    LAUNCHER_SETTINGS,
    batched_branch_bound_slam,
    correlative_loop_slam,
    cuda_device,  # noqa: F401 (fixture)
    default_loop_slam,
    distributed_loop_slam,
    gather_loop_slam,
    loop_sequence,
    loop_slam,
    multihost_loop_slam,
    office_sequence,
    settings_slam,
)
from torch_counters import PerCall, dense_reruns, kernel_refines

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
# The frontend slice, card against CPU: one grid cell (0.05 m) in x and y,
# one theta search step at 20 m range (2 asin(0.025 / 20) = 0.0025 rad) in
# heading.  f32 rounding that differs between the card and the CPU (trig,
# sigmoid, summation order) can move a CSM argmax by one search cell at
# most, and GN refinement pulls it back; a larger disagreement is a fault.
POSE_TOL = (0.05, 0.0025)
# The branch-and-bound loop slice: one grid cell, two theta search steps
# at 20 m range.  Both devices take the same exact integer scores; f32 trig
# may move a beam's cell, and the GN refinement and the f32 LM solve
# (cuSOLVER and LAPACK) round differently after each loop closure.
LOOP_TOL = (0.05, 0.005)
# The multi-device paths against the main path's poses.  A one-shard mesh
# sums the LM in the single-device order and two ranks' f64 sums differ
# from one rank's only in order, far below the f32 rounding (bitwise in the
# CPU tests), so bitwise is expected; 1e-4 m / rad would let a last-bit
# flip after a loop closure pass without hiding a wrong sum.
DIST_TOL = 1e-4
# A system that varies one backend of another: its ATE within this of the
# other's (the two worker processes, the gather backend, the scatter
# rasterizer).
ATE_TOL = 0.005
WORKER_TIMEOUT_S = 300
# f32-map matches against the u8 matches of the same query: the same found
# flag, and where both found a pose, within one cell and 0.02 rad (a few
# theta steps at the loop window): the u8 map moves each probability by at
# most 1/510, which may move a near-tie argmax by a cell.
F32_U8_TOL = (0.05, 0.02)
# The f32-map queries matched on the CPU too (those the u8 match found a
# pose for first), poses bitwise equal.
F32_CPU_QUERIES = 4


def sweeps():
    return csm_cuda.LAUNCHES


def hit_images():
    return hit_images_cuda.LAUNCHES


def frontend_slam(device, **factory_kw):
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_slam,
    )

    return create_default_slam(device=device, **factory_kw)


def drive(device, seq, make_slam, hook=None, **factory_kw):
    """Drive ``make_slam(device, **factory_kw)`` over ``seq``, inline;
    ``hook(slam)`` runs before the first scan.  Returns the trajectory,
    ground truth at keyframes, loop edges, the system and the sweep and
    hit-image launches of the run."""
    device = torch.device(device)
    slam = make_slam(device, **factory_kw)
    if hook is not None:
        hook(slam)
    s0, h0 = sweeps(), hit_images()
    gt = []
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    slam.stop_backend()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(est=slam.get_trajectory(), gt=np.asarray(gt), slam=slam,
                loops=[(e.local_map_node_id, e.scan_node_id)
                       for e in slam.pose_graph.edges if e.is_loop],
                sweeps=sweeps() - s0, hit_images=hit_images() - h0)


def ate(run):
    return synthetic.ate_rmse(run["est"], run["gt"])


def odometry_ate(seq):
    return synthetic.ate_rmse(np.stack([s.odom_pose for s in seq.scans]),
                              seq.ground_truth)


def assert_same(gpu, cpu, tol=None):
    """The same keyframes and loop edges; poses bitwise equal, or within
    ``tol`` (x and y, heading)."""
    assert len(gpu["est"]) == len(cpu["est"])
    assert gpu["loops"] == cpu["loops"]
    if tol is None:
        np.testing.assert_array_equal(gpu["est"], cpu["est"])
    else:
        d = np.abs(gpu["est"] - cpu["est"])
        assert d[:, :2].max() <= tol[0] and d[:, 2].max() <= tol[1], d.max(0)


def assert_beats_odometry(run, seq):
    assert np.all(np.isfinite(run["est"]))
    assert ate(run) < odometry_ate(seq)


@contextlib.contextmanager
def refine_count():
    """The refinements on the card inside the block
    (``gauss_newton.refine`` on a CUDA tensor) beside the Gauss-Newton
    launches and the rise of ``GaussNewton.KernelRefines``."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import (
        gauss_newton,
        gauss_newton_cuda,
    )

    refine, n = gauss_newton.refine, dict(calls=0)

    def counted(prob, *args, **kw):
        n["calls"] += prob.device.type == "cuda"
        return refine(prob, *args, **kw)

    gauss_newton.refine = counted
    l0, k0 = gauss_newton_cuda.LAUNCHES, kernel_refines()
    try:
        yield n
    finally:
        gauss_newton.refine = refine
        n.update(launches=gauss_newton_cuda.LAUNCHES - l0,
                 kernel_refines=kernel_refines() - k0)


def count_detects(runs):
    """A ``hook`` that records each ``detect`` of the loop detector
    (:class:`PerCall`: its batch, sweep launches and dense re-runs) into
    ``runs["detects"]``."""
    def hook(slam):
        runs["detects"] = PerCall(slam.backend.loop_detector, "detect",
                                  sweeps=sweeps, reruns=dense_reruns)
    return hook


def count_loop_matches(runs):
    """A ``hook`` that records each call of the loop matcher's
    ``optimize_pose`` and its sweep launches into ``runs["matches"]``."""
    def hook(slam):
        runs["matches"] = PerCall(slam.backend.loop_detector.scan_matcher,
                                  "optimize_pose", sweeps=sweeps)
    return hook


def assert_two_launches_per_detect(detects):
    """At least one batched ``detect`` with candidates, each two sweep
    launches (coarse, fine) plus two per dense re-run."""
    batches = [c for c in detects.calls if c["size"]]
    assert batches
    assert all(c["sweeps"] == 2 + 2 * c["reruns"] for c in batches), batches


@pytest.fixture(scope="module")
def office():
    return office_sequence()


@pytest.fixture(scope="module")
def loop_world():
    return loop_sequence()


@pytest.fixture(scope="module")
def frontend_runs(cuda_device, office):
    """The default frontend (``create_default_slam``) over the office."""
    with refine_count() as refines:
        gpu = drive(cuda_device, office, frontend_slam)
    return dict(gpu=gpu, cpu=drive("cpu", office, frontend_slam),
                refines=refines)


def test_frontend_slice_on_the_card_is_the_cpus(frontend_runs, office):
    gpu, cpu = frontend_runs["gpu"], frontend_runs["cpu"]
    assert len(gpu["est"]) >= 40
    assert_same(gpu, cpu, tol=POSE_TOL)
    assert_beats_odometry(gpu, office)


def test_frontend_slice_launches(frontend_runs):
    """Two sweeps or more a matched keyframe; every refinement on the card
    is one Gauss-Newton launch and one ``GaussNewton.KernelRefines``, at
    least one a matched keyframe."""
    matched = len(frontend_runs["gpu"]["est"]) - 1
    refines = frontend_runs["refines"]
    assert frontend_runs["gpu"]["sweeps"] >= 2 * matched
    assert refines["calls"] == refines["launches"] == refines["kernel_refines"]
    assert refines["launches"] >= matched


def test_hill_climbing_frontend_on_the_card_is_the_cpus(cuda_device, office):
    """The reference's HillClimbing frontend with its GreedyEndpoint cost:
    bitwise-equal poses, ATE below odometry's, and no sweep launch."""
    make = settings_slam(HILL_CLIMBING_SETTINGS)
    gpu = drive(cuda_device, office, make)
    assert len(gpu["est"]) >= 40
    assert_same(gpu, drive("cpu", office, make))
    assert_beats_odometry(gpu, office)
    assert gpu["sweeps"] == 0


def test_scatter_rasterizer_on_the_card_is_the_cpus(cuda_device, office,
                                                    frontend_runs):
    """The default frontend with ``rasterize_backend="scatter"``: its
    keyframes, bitwise-equal poses on both devices, ATE within 0.005 m of
    the matmul rasterizer's, two sweeps or more a matched keyframe."""
    kw = dict(builder_overrides=dict(rasterize_backend="scatter"))
    gpu = drive(cuda_device, office, frontend_slam, **kw)
    assert_same(gpu, drive("cpu", office, frontend_slam, **kw))
    assert len(gpu["est"]) == len(frontend_runs["gpu"]["est"])
    assert_beats_odometry(gpu, office)
    assert abs(ate(gpu) - ate(frontend_runs["gpu"])) <= ATE_TOL
    assert gpu["sweeps"] >= 2 * (len(gpu["est"]) - 1)


@pytest.fixture(scope="module")
def branch_bound_runs(cuda_device, loop_world):
    return dict(gpu=drive(cuda_device, loop_world, loop_slam),
                cpu=drive("cpu", loop_world, loop_slam))


def test_branch_bound_loop_slice_on_the_card_is_the_cpus(branch_bound_runs,
                                                         loop_world):
    gpu = branch_bound_runs["gpu"]
    assert gpu["loops"]
    assert_same(gpu, branch_bound_runs["cpu"], tol=LOOP_TOL)
    assert_beats_odometry(gpu, loop_world)


def test_branch_bound_loop_slice_launches(branch_bound_runs):
    """One hit-image launch a branch-and-bound match; the frontend's two
    sweeps or more a matched keyframe."""
    gpu = branch_bound_runs["gpu"]
    matches = gpu["slam"].backend.loop_detector.scan_matcher.matches
    assert matches >= 1
    assert gpu["hit_images"] == matches
    assert gpu["sweeps"] >= 2 * (len(gpu["est"]) - 1)


def compare_branch_bound_steps(runs):
    """A ``hook`` that, at each ``detect`` of the batched branch-and-bound
    detector, first matches the same queries with the serial
    ``ScanMatcherBranchBound`` (the blocks it sweeps), then records the
    batched call's hit-image launches and the rise of its counters into
    ``runs["steps"]``."""
    from my_lidar_graph_slam_v2_tpu_torch.core import pose as P
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import scan_to_arrays
    from my_lidar_graph_slam_v2_tpu_torch.matching.branch_bound import (
        ScanMatcherBranchBound,
    )
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
        ScanMatchingQuery,
    )
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )

    def counter(name):
        return MetricManager.instance().counter(
            f"LoopDetector.BranchBound.{name}").value

    def hook(slam):
        det = slam.backend.loop_detector
        serial = ScanMatcherBranchBound(det.mcfg, det.device)
        detect, runs["steps"] = det.detect, []

        def compared(queries):
            s0 = serial.blocks_swept
            for q in queries:
                serial.optimize_pose(
                    ScanMatchingQuery(
                        det.map_cache.raster(q["local_map"]),
                        scan_to_arrays(q["query_node"].scan_data,
                                       det.cfg.beam_capacity, det.device),
                        P.inverse_compound(q["local_map_node"].global_pose,
                                           q["query_node"].global_pose)),
                    score_threshold=det.cfg.score_threshold,
                    known_rate_threshold=det.cfg.known_rate_threshold)
            h0, b0, r0 = hit_images(), counter("BlocksSwept"), counter("Rounds")
            out = detect(queries)
            runs["steps"].append(dict(
                size=len(queries), hit_images=hit_images() - h0,
                blocks=counter("BlocksSwept") - b0,
                serial_blocks=serial.blocks_swept - s0,
                rounds=counter("Rounds") - r0))
            return out

        det.detect = compared
    return hook


@pytest.fixture(scope="module")
def batched_branch_bound_runs(cuda_device, loop_world):
    """The batched branch-and-bound detector
    (``create_default_backend(loop_detector="BranchBound")``) on config
    #3's world, its program spans traced on the card."""
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )

    mm, runs = MetricManager.instance(), {}
    was_tracing = mm.tracing
    mm.start_tracing(ranges=False)
    n0 = len(mm.trace_records())
    try:
        runs["gpu"] = drive(cuda_device, loop_world, batched_branch_bound_slam,
                            hook=compare_branch_bound_steps(runs))
        mm.close_record()  # the spans after the last keyframe's record
        runs["rounds_spans"] = sum(
            1 for r in mm.trace_records()[n0:] for sp in r.spans
            if sp[0] == "bb.round")
    finally:
        if not was_tracing:
            mm.stop_tracing()
    runs["cpu"] = drive("cpu", loop_world, batched_branch_bound_slam)
    return runs


def test_batched_branch_bound_slice_on_the_card_is_the_cpus(
        batched_branch_bound_runs, branch_bound_runs, loop_world):
    """The batched detector on the card: the CPU's keyframes and loop
    edges, poses within the serial slice's tolerance, and the serial
    branch-and-bound slice's results bit for bit on the same device."""
    gpu = batched_branch_bound_runs["gpu"]
    assert gpu["loops"]
    assert_same(gpu, batched_branch_bound_runs["cpu"], tol=LOOP_TOL)
    assert_same(gpu, branch_bound_runs["gpu"])
    assert_beats_odometry(gpu, loop_world)


def test_batched_branch_bound_slice_launches(batched_branch_bound_runs):
    """One hit-image launch a step whatever its candidates; the blocks
    the batched descent counts are the serial matcher's on the same
    queries; ``.Rounds`` rises once a ``bb.round`` span."""
    steps = [s for s in batched_branch_bound_runs["steps"] if s["size"]]
    assert steps and any(s["size"] > 1 for s in steps)
    assert all(s["hit_images"] == 1 for s in steps), steps
    assert all(s["blocks"] == s["serial_blocks"] for s in steps), steps
    rounds = sum(s["rounds"] for s in steps)
    assert rounds == batched_branch_bound_runs["rounds_spans"] >= 1


@pytest.fixture(scope="module")
def serial_runs(cuda_device, loop_world):
    """The serial correlative detector
    (``create_default_backend(sharded=False)``) on config #3's world."""
    runs = {}
    runs["gpu"] = drive(cuda_device, loop_world, correlative_loop_slam,
                        hook=count_loop_matches(runs))
    runs["cpu"] = drive("cpu", loop_world, correlative_loop_slam)
    return runs


def test_serial_loop_slice_on_the_card_is_the_cpus(serial_runs, loop_world):
    gpu = serial_runs["gpu"]
    assert gpu["loops"]
    assert_same(gpu, serial_runs["cpu"])
    assert_beats_odometry(gpu, loop_world)


def test_serial_loop_slice_launches(serial_runs):
    """Two sweep launches or more (coarse, fine, dense re-runs) a loop
    match."""
    matches = serial_runs["matches"]
    assert matches.calls
    assert matches.total("sweeps") >= 2 * len(matches.calls)


def test_the_matchers_replay_their_searches(frontend_runs, serial_runs):
    """The frontend's fused matcher and the serial loop detector's each
    hold a captured search for each key they met, the pruned search and
    at most its dense re-run, and replayed them."""
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )

    mm = MetricManager.instance()
    for m in (frontend_runs["gpu"]["slam"].frontend.scan_matcher,
              serial_runs["gpu"]["slam"].backend.loop_detector.scan_matcher):
        dense = [key[1] for key in m._search._graphs]
        assert dense and len(set(dense)) == len(dense) <= 2, m.name
        assert mm.counter(f"{m.name}.GraphReplays").value > 0, m.name


def test_gather_backend_loop_slice_on_the_card_is_the_cpus(
        cuda_device, loop_world, serial_runs):
    """The serial detector's matcher on the gather sweep backend: the
    serial slice's keyframes, bitwise-equal poses on both devices, ATE
    within 0.005 m of the serial slice's, two sweep launches or more a
    loop match."""
    runs = {}
    gpu = drive(cuda_device, loop_world, gather_loop_slam,
                hook=count_loop_matches(runs))
    assert gpu["loops"]
    assert_same(gpu, drive("cpu", loop_world, gather_loop_slam))
    assert len(gpu["est"]) == len(serial_runs["gpu"]["est"])
    assert_beats_odometry(gpu, loop_world)
    assert abs(ate(gpu) - ate(serial_runs["gpu"])) <= ATE_TOL
    assert runs["matches"].calls
    assert runs["matches"].total("sweeps") >= 2 * len(runs["matches"].calls)


@pytest.fixture(scope="module")
def batched_runs(cuda_device, loop_world):
    """The main path: ``create_default_backend()``, the batched detector,
    on config #3's world."""
    runs = {}
    with refine_count() as refines:
        runs["gpu"] = drive(cuda_device, loop_world, default_loop_slam,
                            hook=count_detects(runs))
    runs.update(cpu=drive("cpu", loop_world, default_loop_slam),
                refines=refines)
    return runs


def test_batched_loop_slice_on_the_card_is_the_cpus(batched_runs, loop_world):
    gpu = batched_runs["gpu"]
    assert gpu["loops"]
    assert_same(gpu, batched_runs["cpu"])
    assert_beats_odometry(gpu, loop_world)


def test_batched_loop_slice_launches(batched_runs):
    """Two sweep launches a ``detect`` plus two a dense re-run; every
    refinement on the card one Gauss-Newton launch and one
    ``GaussNewton.KernelRefines``."""
    assert_two_launches_per_detect(batched_runs["detects"])
    refines = batched_runs["refines"]
    assert refines["calls"] == refines["launches"] == refines["kernel_refines"]
    assert refines["launches"] >= 1


def test_grid_search_loop_slice_on_the_card_is_the_cpus(cuda_device,
                                                        loop_world):
    """A GridSearch loop detector built from settings at the reference's
    steps, GreedyEndpoint cost: bitwise-equal poses, a loop edge, ATE
    below odometry's, one sweep launch a grid-search match."""
    make, runs = settings_slam(GRID_SEARCH_SETTINGS), {}
    gpu = drive(cuda_device, loop_world, make, hook=count_loop_matches(runs))
    assert gpu["loops"]
    assert_same(gpu, drive("cpu", loop_world, make))
    assert_beats_odometry(gpu, loop_world)
    assert runs["matches"].calls
    assert all(c["sweeps"] == 1 for c in runs["matches"].calls)


def _png_shape(path):
    """(rows, cols) of an 8-bit grey PNG, its image data decompressed to
    check that it is whole."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    assert len(zlib.decompress(idat)) == h * (w + 1)
    return h, w


def test_launcher_lands_on_the_card(cuda_device, loop_world, batched_runs,
                                    tmp_path):
    """The user's entry point: config #3's world as a Carmen log through
    ``launcher.main`` with a settings file and no ``--device``, so on the
    card.  The saved pose graph, read back, has the main path's keyframes
    (the gate reads odometry alone), a loop edge and ATE below odometry's;
    the map PNG and the metrics JSON parse."""
    from my_lidar_graph_slam_v2_tpu_torch.io.carmen import write_carmen_log
    from my_lidar_graph_slam_v2_tpu_torch.io.map_saver import load_pose_graph
    from my_lidar_graph_slam_v2_tpu_torch.pipeline import launcher

    write_carmen_log(loop_world.scans, str(tmp_path / "config3.log"))
    (tmp_path / "settings.json").write_text(json.dumps(LAUNCHER_SETTINGS))
    prefix = tmp_path / "config3"
    s0 = sweeps()
    assert launcher.main([str(tmp_path / "config3.log"),
                          str(tmp_path / "settings.json"), str(prefix)]) == 0
    assert sweeps() > s0
    pg = load_pose_graph(f"{prefix}.posegraph.json")
    assert len(pg.scan_nodes) == len(batched_runs["gpu"]["est"])
    assert sum(e.is_loop for e in pg.edges) >= 1
    # The saved graph's time stamps say which scans became keyframes.
    stamps = [n["TimeStamp"] for n in json.loads(
        Path(f"{prefix}.posegraph.json").read_text())["ScanNodes"]]
    times = np.array([s.time_stamp for s in loop_world.scans])
    gt = loop_world.ground_truth[[int(np.argmin(np.abs(times - t)))
                                  for t in stamps]]
    assert_beats_odometry(dict(est=pg.scan_poses(), gt=gt), loop_world)
    meta = json.loads(Path(f"{prefix}.json").read_text())["Map"]
    assert list(_png_shape(Path(f"{prefix}.png"))) == [meta["Rows"],
                                                       meta["Cols"]]
    metrics = json.loads(Path(f"{prefix}.metric.json").read_text())
    assert "Frontend.ProcessTime" in metrics["ValueSequences"]


def assert_like_the_main_path(runs, main):
    """A multi-device run on the card: the CPU's poses bit for bit, the
    main path's keyframes and loop edges, its poses within ``DIST_TOL``,
    and the main path's launch contract."""
    gpu = runs["gpu"]
    assert_same(gpu, runs["cpu"])
    assert len(gpu["est"]) == len(main["gpu"]["est"])
    assert gpu["loops"] == main["gpu"]["loops"]
    assert np.abs(gpu["est"] - main["gpu"]["est"]).max() <= DIST_TOL
    assert_two_launches_per_detect(runs["detects"])


@pytest.fixture(scope="module")
def distributed_runs(cuda_device, loop_world):
    """``create_distributed_backend`` on a one-device mesh."""
    runs = {}
    runs["gpu"] = drive(cuda_device, loop_world, distributed_loop_slam,
                        hook=count_detects(runs))
    runs["cpu"] = drive("cpu", loop_world, distributed_loop_slam)
    return runs


def test_distributed_backend_on_one_card(distributed_runs, batched_runs):
    assert_like_the_main_path(distributed_runs, batched_runs)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_multihost_backend_in_a_group_of_one(cuda_device, loop_world,
                                            batched_runs):
    """``create_multihost_backend`` in this process: on the card in an
    NCCL group of one rank (the only NCCL group one card can hold), on the
    CPU in a gloo group of one rank, each group destroyed after its run."""
    import torch.distributed as dist

    from my_lidar_graph_slam_v2_tpu_torch.parallel import multihost

    runs = {}
    for key, backend, dev in (("gpu", "nccl", cuda_device),
                              ("cpu", "gloo", torch.device("cpu"))):
        multihost.init_multihost(f"tcp://localhost:{_free_port()}", 1, 0,
                                 backend=backend)
        try:
            runs[key] = drive(dev, loop_world, multihost_loop_slam,
                              hook=count_detects(runs) if key == "gpu"
                              else None)
        finally:
            dist.destroy_process_group()
    assert_like_the_main_path(runs, batched_runs)


def test_two_worker_processes_on_one_card(cuda_device, batched_runs,
                                          distributed_runs):
    """Two ``parallel/worker.py`` processes (gloo, both on the card, config
    #3's world at the factory defaults): lockstep bitwise, the main path's
    keyframes, loop edges and poses, ATE within 0.005 m of it, each rank's
    rasterized maps its own, the owner-retention invariants, and both
    ranks' sharded global maps with the observed cells of the one-device
    mesh's run's map built in this one process."""
    from my_lidar_graph_slam_v2_tpu_torch.parallel.multihost import (
        construct_global_map_sharded,
    )
    from my_lidar_graph_slam_v2_tpu_torch.parallel.worker import (
        check_owner_sharded,
    )

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "my_lidar_graph_slam_v2_tpu_torch.parallel.worker",
         "--init-method", f"tcp://localhost:{port}", "--world-size", "2",
         "--rank", str(rank), "--backend", "gloo", "--device",
         str(cuda_device), "--world", "config3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    r0, r1 = outs
    main = batched_runs["gpu"]
    t0, t1 = (np.array(r["trajectory"]) for r in (r0, r1))
    loops = [[tuple(e) for e in r["loop_edges"]] for r in (r0, r1)]
    np.testing.assert_array_equal(t0, t1)
    assert loops[0] == loops[1] == main["loops"]
    assert r0["keyframes"] == len(main["est"])
    np.testing.assert_array_equal(t0, main["est"])
    assert abs(r0["ate"] - ate(main)) <= ATE_TOL
    for r in (r0, r1):
        assert all(m % 2 == r["process_id"] for m in r["rasterized_map_ids"])
    assert r0["detect_sweep_launches"] + r1["detect_sweep_launches"]
    check_owner_sharded(r0, r1)
    _, gmap = construct_global_map_sharded(distributed_runs["gpu"]["slam"])
    cells = int(gmap.observed.sum())
    assert (r0["global_map_observed_cells"]
            == r1["global_map_observed_cells"] == cells > 0)


def _f32_matchers(device, mcfg):
    """The matchers held on f32 maps: the batched loop detector's
    correlative config at "highest" and "split" and with the gather sweep
    backend (the whole map as the window), the grid search at the
    reference's steps and branch-and-bound at the ``BranchBoundConfig``
    defaults."""
    import dataclasses

    from my_lidar_graph_slam_v2_tpu_torch.matching.branch_bound import (
        BranchBoundConfig,
        ScanMatcherBranchBound,
    )
    from my_lidar_graph_slam_v2_tpu_torch.matching.correlative import (
        ScanMatcherCorrelative,
    )
    from my_lidar_graph_slam_v2_tpu_torch.matching.grid_search import (
        GridSearchConfig,
        ScanMatcherGridSearch,
    )

    tag = device.type
    return {
        "correlative_highest": ScanMatcherCorrelative(
            dataclasses.replace(mcfg, precision="highest"), device,
            name=f"F32Maps.{tag}.CorrelativeHighest"),
        "correlative_split": ScanMatcherCorrelative(
            dataclasses.replace(mcfg, precision="split"), device,
            name=f"F32Maps.{tag}.CorrelativeSplit"),
        "correlative_gather": ScanMatcherCorrelative(
            dataclasses.replace(mcfg, sweep_backend="gather"), device,
            name=f"F32Maps.{tag}.CorrelativeGather"),
        "grid_search": ScanMatcherGridSearch(GridSearchConfig(), device),
        "branch_bound": ScanMatcherBranchBound(BranchBoundConfig(), device),
    }


def _raster_on(raster, device):
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import MapRaster

    return MapRaster(raster.prob.to(device), raster.observed.to(device),
                     raster.resolution, raster.offset_xy)


@pytest.fixture(scope="module")
def f32_maps(cuda_device, loop_world):
    """The main path on config #3's world with its finished maps kept as
    f32 log-odds, each loop query (with its map-local pose as the detector
    got it) matched against its local map as an f32 probability raster
    (``rasterize.prob_map``, 1024 x 1024 at 5 cm) by every matcher of
    :func:`_f32_matchers` on the card, and as the map cache's u8 raster by
    the correlative ("split"), grid-search and branch-and-bound matchers;
    per f32 match its pose, found flag, the u8 match's, and the f32 sweep,
    pack, u8 sweep and hit-image launches and dense re-runs it made."""
    from my_lidar_graph_slam_v2_tpu_torch.core import pose as P
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import scan_to_arrays
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
        MapRaster,
        ScanMatchingQuery,
    )
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )
    from my_lidar_graph_slam_v2_tpu_torch.ops import rasterize

    queries = []

    def capture(slam):
        det = slam.backend.loop_detector
        detect = det.detect

        def captured(qs):
            queries.extend(dict(
                local_map=q["local_map"], scan=q["query_node"].scan_data,
                pose=P.inverse_compound(q["local_map_node"].global_pose,
                                        q["query_node"].global_pose))
                for q in qs)
            return detect(qs)

        det.detect = captured

    run = drive(cuda_device, loop_world, default_loop_slam, hook=capture,
                builder_overrides=dict(compact_finished_maps=False))
    det = run["slam"].backend.loop_detector
    thr = (float(np.float32(det.cfg.score_threshold)),
           float(np.float32(det.cfg.known_rate_threshold)))
    rasters = {}
    for q in queries:
        lm = q["local_map"]
        if lm.local_map_id not in rasters:
            rasters[lm.local_map_id] = (
                MapRaster(rasterize.prob_map(lm.logodds, lm.observed),
                          lm.observed, det.resolution, lm.offset_xy),
                det.map_cache.raster(lm))
        q["f32"], q["u8"] = rasters[lm.local_map_id]
    matchers = _f32_matchers(cuda_device, det.mcfg)
    u8_matchers = dict(correlative=matchers["correlative_split"],
                       grid_search=matchers["grid_search"],
                       branch_bound=matchers["branch_bound"])
    mm = MetricManager.instance()

    def reruns(m):
        name = getattr(m, "name", None)
        return mm.counter(f"{name}.DenseFallbacks").value if name else 0

    counters = dict(f32=lambda: csm_cuda.F32_LAUNCHES,
                    pack=lambda: csm_cuda.F32_PACK_LAUNCHES, u8=sweeps,
                    hits=hit_images)
    rows = {name: [] for name in matchers}
    for q in queries:
        arrays = scan_to_arrays(q["scan"], det.cfg.beam_capacity, cuda_device)
        u8 = {k: m.optimize_pose(ScanMatchingQuery(q["u8"], arrays,
                                                   q["pose"]), *thr)
              for k, m in u8_matchers.items()}
        for name, m in matchers.items():
            before = {k: c() for k, c in counters.items()}
            r0 = reruns(m)
            r = m.optimize_pose(ScanMatchingQuery(q["f32"], arrays,
                                                  q["pose"]), *thr)
            ref = u8[name.split("_")[0] if name.startswith("corr") else name]
            row = {k: c() - before[k] for k, c in counters.items()}
            row.update(reruns=reruns(m) - r0, found=r.pose_found,
                       found_u8=ref.pose_found,
                       pose=np.asarray(r.estimated_pose),
                       pose_u8=np.asarray(ref.estimated_pose))
            rows[name].append(row)
    # The CPU's queries: the first the u8 loop match found a pose for, then
    # the others in order.
    found = [i for i, r in enumerate(rows["correlative_split"])
             if r["found_u8"]]
    order = found + [i for i in range(len(queries)) if i not in found]
    return dict(run=run, queries=queries, rows=rows, det=det, thr=thr,
                matchers=matchers, device=cuda_device,
                cpu_queries=order[:F32_CPU_QUERIES])


def test_f32_map_run_is_the_main_paths(f32_maps, batched_runs):
    run = f32_maps["run"]
    assert run["loops"] == batched_runs["gpu"]["loops"]
    assert len(run["est"]) == len(batched_runs["gpu"]["est"])
    assert len(f32_maps["queries"]) >= F32_CPU_QUERIES


def test_f32_map_matches_launch_their_kernels(f32_maps):
    """Per f32 match: two f32 sweeps a correlative match, one a
    grid-search match, none for branch-and-bound, each again per dense
    re-run; one pack a sweep; no u8 sweep; one hit-image launch a
    branch-and-bound match."""
    for name, rows in f32_maps["rows"].items():
        want = {"grid_search": 1, "branch_bound": 0}.get(name, 2)
        for r in rows:
            assert r["f32"] == want * (1 + r["reruns"]), (name, r)
            assert r["pack"] == r["f32"] and r["u8"] == 0, (name, r)
            assert r["hits"] == (name == "branch_bound"), (name, r)


def test_f32_map_matches_follow_the_u8_matches(f32_maps):
    for name, rows in f32_maps["rows"].items():
        for r in rows:
            assert r["found"] == r["found_u8"], name
            if r["found"]:
                d = np.abs(r["pose"] - r["pose_u8"])
                assert d[:2].max() <= F32_U8_TOL[0], (name, d)
                assert d[2] <= F32_U8_TOL[1], (name, d)


def _match_on_the_cpu(f32_maps, raster_of):
    """The CPU queries matched on the CPU by every f32-map matcher against
    ``raster_of(query)`` (a card raster, moved), and on the card too where
    the fixture did not; each pair bitwise equal."""
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import scan_to_arrays
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
        ScanMatchingQuery,
    )

    det, thr, cuda = f32_maps["det"], f32_maps["thr"], f32_maps["device"]
    cpu_m = _f32_matchers(torch.device("cpu"), det.mcfg)
    for i in f32_maps["cpu_queries"]:
        q = f32_maps["queries"][i]
        raster = raster_of(q)
        for name, m in cpu_m.items():
            c = m.optimize_pose(ScanMatchingQuery(
                _raster_on(raster, "cpu"),
                scan_to_arrays(q["scan"], det.cfg.beam_capacity, "cpu"),
                q["pose"]), *thr)
            if raster is q["f32"]:
                g = f32_maps["rows"][name][i]
                g_found, g_pose = g["found"], g["pose"]
            else:
                g = f32_maps["matchers"][name].optimize_pose(
                    ScanMatchingQuery(raster, scan_to_arrays(
                        q["scan"], det.cfg.beam_capacity, cuda), q["pose"]),
                    *thr)
                g_found, g_pose = g.pose_found, np.asarray(g.estimated_pose)
            assert c.pose_found == g_found, (i, name)
            np.testing.assert_array_equal(np.asarray(c.estimated_pose),
                                          g_pose)


def test_f32_map_matches_on_the_card_are_the_cpus(f32_maps):
    _match_on_the_cpu(f32_maps, lambda q: q["f32"])


def test_f32_map_matches_below_2_18_on_the_card_are_the_cpus(f32_maps):
    """The CPU queries again on their f32 rasters with every free cell
    (observed, probability below 0.5) at 1e-7, below 2^-18."""
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import MapRaster

    def small(q):
        r = q["f32"]
        free = r.observed & (r.prob < 0.5)
        assert free.any()
        return MapRaster(torch.where(free, 1e-7, r.prob), r.observed,
                         r.resolution, r.offset_xy)

    _match_on_the_cpu(f32_maps, small)
