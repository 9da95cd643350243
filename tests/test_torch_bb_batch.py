"""Branch-and-bound over a batch of candidates
(``matching/branch_bound.py:BranchBoundBatch``, the batched loop detector
``parallel/loop_sharded.py:LoopDetectorShardedBranchBound``) against the
serial core, the plain exhaustive reference
(``slam_bench/reference/branch_bound.py``) and, end to end,
the settings path's serial detector.

Seeded random u8 maps at a small size (crop 64, T 16, NodeHeightMax 3:
bounds over 8-cell blocks), a candidate that clears no gate (its beams
off the map, or an unobserved map) and tied bounds (a uniform map).

Tolerances, fixed before the first run:
- batched against serial: pose, score and found bit for bit, blocks swept
  equal.  Every sum is an exact integer, and the host replays the serial
  stop rule over the same sums;
- against the reference: where one pose alone holds the gated maximum
  and it clears the score gate, the same pose within 1e-5 (the
  reference's f64 pose from the same f32 inputs); the score within rtol 1e-6 always (the program rounds the sum
  times 1/255 and 1/n in f32, the reference divides in f64);
- end to end: the same keyframes and loop edges, poses bit for bit.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from my_lidar_graph_slam_v2_tpu_torch.config.settings import (
    create_slam_from_settings,
)
from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
from my_lidar_graph_slam_v2_tpu_torch.loop.detector import (
    LoopDetectorBranchBound,
)
from my_lidar_graph_slam_v2_tpu_torch.matching import branch_bound as bb
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager
from my_lidar_graph_slam_v2_tpu_torch.ops import csm, pool
from my_lidar_graph_slam_v2_tpu_torch.parallel.loop_sharded import (
    LoopDetectorShardedBranchBound,
)
from my_lidar_graph_slam_v2_tpu_torch.pipeline import factory
from slam_bench.reference import branch_bound as ref_bb
from torch_counters import host_fetches
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RES = 0.05
SIZE = 160
CFG = bb.BranchBoundConfig(node_height_max=3, range_x=1.2, range_y=1.2,
                           range_theta=0.5, n_theta_max=16, crop_rows=64,
                           crop_cols=64)
BEAMS = 52
THR, KTHR = 0.45, 0.6
REF_POSE_TOL = 1e-5
REF_SCORE_RTOL = 1e-6


def random_map(rng, kind="walls"):
    """A u8 level map and its observed mask: random walls of high levels
    on low noise, all observed ("walls"); one level everywhere ("uniform":
    every bound ties); or nothing observed ("unobserved")."""
    if kind == "uniform":
        return (torch.full((SIZE, SIZE), 180, dtype=torch.uint8),
                torch.ones((SIZE, SIZE), dtype=torch.bool))
    prob = rng.integers(0, 40, (SIZE, SIZE))
    for _ in range(8):
        r, c = rng.integers(0, SIZE, 2)
        length = int(rng.integers(6, 30))
        if rng.random() < 0.5:
            prob[r, c:c + length] = rng.integers(200, 256)
        else:
            prob[r:r + length, c] = rng.integers(200, 256)
    observed = np.ones((SIZE, SIZE), bool)
    if kind == "unobserved":
        observed[:] = False
    return torch.as_tensor(prob.astype(np.uint8)), torch.as_tensor(observed)


def random_scan(rng, n_valid=48):
    ranges = np.zeros(BEAMS, np.float32)
    ranges[:n_valid] = rng.uniform(0.4, 1.3, n_valid)
    angles = np.linspace(-np.pi, np.pi, BEAMS, endpoint=False).astype(
        np.float32)
    mask = np.zeros(BEAMS, bool)
    mask[:n_valid] = True
    return ranges, angles, mask


def paint(prob, scan, pose, rng):
    """Draw the scan's endpoints at ``pose`` into ``prob`` at high levels,
    so a pose near it scores well."""
    r, a, m = scan
    ang = pose[2] + a[m]
    col = np.floor((pose[0] + r[m] * np.cos(ang)) / RES).astype(int)
    row = np.floor((pose[1] + r[m] * np.sin(ang)) / RES).astype(int)
    prob[row, col] = rng.integers(220, 256, len(row))


def candidates(seed, n, shared):
    """``n`` candidates: maps (stacked), map index, beams, sensor poses,
    offsets.  Each scan is drawn into its map at a pose up to 0.4 m and
    0.15 rad from the sensor pose the search starts from.  With
    ``shared`` all on one walled map, the last of three with its beams
    off the map; else each on its own map, the second uniform and the
    third unobserved."""
    rng = np.random.default_rng(seed)
    kinds = ["walls"] if shared else ["walls", "uniform", "unobserved"][:n]
    maps = [random_map(rng, k) for k in kinds]
    scans = [random_scan(rng) for _ in range(n)]
    poses = rng.uniform(3.0, 5.0, (n, 3)).astype(np.float32)
    poses[:, 2] = rng.uniform(-1, 1, n)
    for i, scan in enumerate(scans):
        prob = maps[0 if shared else i][0]
        if kinds[0 if shared else i] == "walls":
            true = poses[i] + np.r_[rng.uniform(-0.4, 0.4, 2),
                                    rng.uniform(-0.15, 0.15)]
            p = prob.numpy()
            paint(p, scan, true, rng)
    if shared and n == 3:
        poses[2, :2] = 30.0
    index = [0] * n if shared else list(range(n))
    off = np.zeros((n, 2), np.float32)
    return dict(
        prob=torch.stack([m[0] for m in maps]),
        observed=torch.stack([m[1] for m in maps]),
        index=index,
        ranges=torch.as_tensor(np.stack([s[0] for s in scans])),
        angles=torch.as_tensor(np.stack([s[1] for s in scans])),
        mask=torch.as_tensor(np.stack([s[2] for s in scans])),
        poses=torch.as_tensor(poses), offsets=torch.as_tensor(off))


def pyramids(c):
    h = CFG.bound_height
    return (pool.pyramid(c["prob"], h)[-1], pool.pyramid(c["observed"], h)[-1])


def serial(c, i):
    m = c["index"][i]
    out, stats = bb.branch_bound_core(
        CFG, c["prob"][m], c["observed"][m],
        pool.pyramid(c["prob"][m], CFG.bound_height)[-1],
        pool.pyramid(c["observed"][m], CFG.bound_height)[-1],
        c["ranges"][i], c["angles"][i], c["mask"][i], c["poses"][i],
        c["offsets"][i], THR, KTHR)
    pose, score, found = (t.numpy() for t in out[:3])
    return pose, score, bool(found), stats["blocks_swept"]


def batched(c, k):
    """One batch of all the candidates, run to its end in rounds of at
    most ``k`` blocks."""
    pyr_p, pyr_o = pyramids(c)
    return bb.descend(lambda: [bb.BranchBoundBatch(
        CFG, c["prob"], c["observed"], pyr_p, pyr_o, c["ranges"],
        c["angles"], c["mask"], c["poses"], c["offsets"], THR, KTHR,
        map_index=torch.as_tensor(c["index"]))], torch.device("cpu"), k)[0]


def counters():
    c = MetricManager.instance().counter
    return {k: c(f"LoopDetector.BranchBound.{k}").value
            for k in ("Matches", "BlocksSwept", "BlocksSpeculative",
                      "Rounds")}


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "distinct"])
def test_batch_is_the_serial_core_bit_for_bit(k, n, shared):
    c = candidates(11 + n, n, shared)
    before, f0 = counters(), host_fetches()
    pose, score, found, swept = batched(c, k)
    fetches = host_fetches() - f0
    after = counters()
    for i in range(n):
        s_pose, s_score, s_found, s_swept = serial(c, i)
        assert pose[i].dtype == np.float32
        np.testing.assert_array_equal(pose[i], s_pose)
        assert np.float32(score[i]) == s_score
        assert bool(found[i]) == s_found
        assert swept[i] == s_swept, (i, swept, s_swept)
    assert found[0], "the walled map's first candidate finds its pose"
    if n == 3:
        assert not found[2], "the third candidate clears no gate"
    rounds = after["Rounds"] - before["Rounds"]
    assert after["Matches"] - before["Matches"] == n
    assert after["BlocksSwept"] - before["BlocksSwept"] == sum(swept)
    assert rounds == max(-(-s // k) for s in swept)
    assert fetches == 1 + rounds
    speculative = after["BlocksSpeculative"] - before["BlocksSpeculative"]
    assert speculative >= 0
    if k == 8 and not shared and n >= 2:
        assert speculative > 0, "a round swept past a stop"


def test_tied_bounds_are_taken_in_the_serial_order():
    """On the uniform map every bound inside the map ties: the stable
    order takes the first block, as the serial core does, and both stop
    at the same block count whatever the round size."""
    c = candidates(5, 2, shared=False)
    got = [batched(c, k) for k in (1, 2, 8)]
    s_pose, s_score, s_found, s_swept = serial(c, 1)
    for pose, score, found, swept in got:
        np.testing.assert_array_equal(pose[1], s_pose)
        assert np.float32(score[1]) == s_score and swept[1] == s_swept
    assert s_swept >= 1


@pytest.mark.parametrize("k", [1, 3, 8])
def test_equal_sums_in_later_blocks_keep_the_first(k):
    """A map that repeats every 8 cells, a block's width: each block holds
    the same best sum at the same theta, and every bound (the 8 x 8
    pyramid's max, 255 everywhere) beats it, so every block is swept and
    the later ones tie the first.  The serial rule keeps the first block's
    winner (a strictly larger sum takes the lead), and so does the batch."""
    rng = np.random.default_rng(9)
    tile = rng.integers(0, 256, (8, 8))
    tile[0, 0] = 255
    c = candidates(9, 1, shared=True)
    c["prob"] = torch.as_tensor(
        np.tile(tile, (SIZE // 8, SIZE // 8)).astype(np.uint8))[None]
    pose, score, found, swept = batched(c, k)
    s_pose, s_score, s_found, s_swept = serial(c, 0)
    assert s_found and s_swept == CFG.blocks[0] * CFG.blocks[1]
    np.testing.assert_array_equal(pose[0], s_pose)
    assert np.float32(score[0]) == s_score and swept[0] == s_swept
    # the winner lies in the first block in bound order: the lowest offsets
    block = 1 << CFG.bound_height
    wx, wy = CFG.win_cells
    off = np.round((pose[0, :2] - c["poses"][0, :2].numpy()) / RES)
    assert np.all(off < block - np.array([wx, wy])), off


def _reference(c, i):
    m = c["index"][i]
    d = dict(range_x=CFG.range_x, range_y=CFG.range_y,
             range_theta=CFG.range_theta, node_height_max=CFG.node_height_max,
             n_theta_max=CFG.n_theta_max, crop=CFG.crop_rows,
             score_threshold=THR, known_rate_threshold=KTHR)
    return ref_bb.match(c["prob"][m], c["observed"][m], c["offsets"][i].numpy(),
                        RES, c["poses"][i].numpy(), c["ranges"][i],
                        c["angles"][i], c["mask"][i], d)


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_batch_and_serial_agree_with_the_exhaustive_reference(seed):
    c = candidates(seed, 3, shared=seed % 2 == 0)
    pose, score, found, _ = batched(c, 3)
    uniques = 0
    for i in range(3):
        r = _reference(c, i)
        s_pose, s_score, s_found, _ = serial(c, i)
        assert bool(found[i]) == r["found"] == s_found
        if r["score"] == -np.inf:
            assert score[i] == -np.inf
            continue
        np.testing.assert_allclose(score[i], r["score"], rtol=REF_SCORE_RTOL)
        if r["unique"] and r["found"]:
            # (a match that clears no gate keeps the initial pose)
            uniques += 1
            np.testing.assert_allclose(pose[i], r["pose"], rtol=0,
                                       atol=REF_POSE_TOL)
            np.testing.assert_allclose(s_pose, r["pose"], rtol=0,
                                       atol=REF_POSE_TOL)
    assert uniques >= 1


def test_the_reference_window_is_the_blocks_window():
    """The reference searches the offsets branch-and-bound's blocks cover:
    -25 to +30 cells at the published 2.5 m window and 8-cell blocks."""
    d = dict(range_x=2.5, range_y=2.5, node_height_max=6)
    wx, wy, nx, ny = ref_bb.window(d, 0.05)
    assert (wx, wy, nx, ny) == (25, 25, 56, 56)
    assert bb.BranchBoundConfig().blocks == (7, 7)


# ---- the batched detector end to end --------------------------------------
SETTINGS = (Path(__file__).resolve().parents[1]
            / "slam_bench/configs/settings_lm.json")
# test_torch_backend.py's sizes: 512^2 maps, 256 beams, T 64, loop crop 384
FRONT = dict(map_rows=512, map_cols=512, beam_capacity=256,
             samples_per_beam=320, usable_range_max=10.0, n_theta_max=64,
             crop=320)
LOOP = dict(n_theta_max=64, crop=384,
            searcher_overrides=dict(travel_dist_threshold=6.0))


def _sequence(module, step=0.16):
    """The world of test_torch_backend.py: a 10 m office, 1.15 laps."""
    world = module.World.office(seed=1, size=10.0)
    traj = module.loop_trajectory(size=10.0, laps=1.15, step=step)
    return module.generate(world, traj, n_beams=141, max_range=10.0,
                           range_noise=0.01, odom_noise=(0.05, 0.02), seed=7)


def _drive(slam, seq):
    for scan in seq.scans:
        slam.process_scan(scan, scan.odom_pose)
    slam.stop_backend()
    loops = [(e.local_map_node_id, e.scan_node_id)
             for e in slam.pose_graph.edges if e.is_loop]
    return slam.get_trajectory(), None, loops


def settings_detector():
    """The settings path's serial branch-and-bound detector: the frozen
    launcher settings with the ``LoopDetectorBranchBound`` group chosen."""
    settings = json.loads(SETTINGS.read_text())
    settings["Backend"].update(LoopDetectorType="BranchBound",
                               LoopDetectorConfigGroup="LoopDetectorBranchBound")
    slam = create_slam_from_settings(settings, map_rows=512, map_cols=512,
                                     n_theta_max=64, loop_crop=384,
                                     inline_backend=True, device="cpu")
    return slam.backend.loop_detector


def drive(backend):
    seq = _sequence(synthetic)
    slam = factory.create_default_slam(device="cpu", backend=backend, **FRONT)
    builds = []
    detect = backend.loop_detector.detect

    def counted(queries):
        n0 = hit_builds["n"]
        out = detect(queries)
        builds.append((len(queries), hit_builds["n"] - n0))
        return out

    backend.loop_detector.detect = counted
    est, _, loops = _drive(slam, seq)
    return est, loops, builds


hit_builds = dict(n=0)


@pytest.fixture(scope="module")
def e2e_runs():
    build = csm.hit_images

    def counted(*a, **k):
        hit_builds["n"] += 1
        return build(*a, **k)

    csm.hit_images = counted
    try:
        batched_backend = factory.create_default_backend(
            device="cpu", loop_detector="BranchBound", **LOOP)
        serial_backend = factory.create_default_backend(
            device="cpu", loop_detector="BranchBound", sharded=False, **LOOP)
        serial_backend.loop_detector = settings_detector()
        return (batched_backend, drive(batched_backend),
                serial_backend, drive(serial_backend))
    finally:
        csm.hit_images = build


def test_factory_branch_bound_is_the_settings_paths(e2e_runs):
    """``create_default_backend(loop_detector="BranchBound")`` closes the
    same loops as the settings path's serial detector, at the same poses,
    with one hit-image build a step whatever its candidates."""
    batched_backend, (est, loops, builds), serial_backend, serial = e2e_runs
    assert isinstance(batched_backend.loop_detector,
                      LoopDetectorShardedBranchBound)
    assert len(loops) >= 1 and loops == serial[1]
    np.testing.assert_array_equal(est, serial[0])
    steps = [b for b in builds if b[0]]
    assert steps and all(n == 1 for _, n in steps), builds
    assert any(q > 1 for q, _ in steps)
    # the serial detector builds once a candidate
    assert sum(n for _, n in serial[2]) == sum(q for q, _ in serial[2])


def test_factory_takes_the_settings_groups_values(e2e_runs):
    batched_backend, _, serial_backend, _ = e2e_runs
    b, s = batched_backend.loop_detector, serial_backend.loop_detector
    assert dataclasses.replace(s.scan_matcher.cfg, cost=None) == b.mcfg
    assert b.mcfg.node_height_max == 6 and b.mcfg.blocks == (7, 7)
    assert (b.cfg.score_threshold, b.cfg.known_rate_threshold) == (
        s.cfg.score_threshold, s.cfg.known_rate_threshold)
    serial_default = factory.create_default_backend(
        device="cpu", loop_detector="BranchBound", sharded=False)
    assert isinstance(serial_default.loop_detector, LoopDetectorBranchBound)
    with pytest.raises(ValueError, match="unknown loop detector"):
        factory.create_default_backend(device="cpu", loop_detector="Grid")


def test_a_mesh_gives_the_one_device_results():
    """Two devices of a mesh (here both the CPU) run their chunks in
    lockstep and give the one-device matches."""
    c = candidates(7, 3, shared=False)
    one = batched(c, 2)
    pyr_p, pyr_o = pyramids(c)

    def start():
        return [bb.BranchBoundBatch(
            CFG, c["prob"], c["observed"], pyr_p, pyr_o,
            c["ranges"][s], c["angles"][s], c["mask"][s], c["poses"][s],
            c["offsets"][s], THR, KTHR,
            map_index=torch.as_tensor(c["index"])[s])
            for s in (slice(0, 2), slice(2, 3))]

    f0 = host_fetches()
    two = bb.descend(start, torch.device("cpu"), 2)
    rounds = max(-(-s // 2) for s in one[3])
    assert host_fetches() - f0 == 1 + rounds
    for k in range(3):
        np.testing.assert_array_equal(
            np.concatenate([two[0][k], two[1][k]]), one[k])
