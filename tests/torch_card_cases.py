"""Seeded inputs, courses, settings and systems shared by the card tests
(``tests/test_torch_cuda*.py``), the CPU tests that compare the same
inputs with the JAX package (``tests/test_torch_csm.py``,
``test_torch_f32_fixed_point.py``, ``test_torch_greedy_slice.py``) and
the card's kernel timings (``chip_smoke.py``, ``sweep_ab.py``).

Imports no JAX, does no work when imported and needs no card: every
course and system is built when a function is called.
"""
import numpy as np
import pytest
import torch

# ---------------------------------------------------------------------------
# The sweep's inputs

TILE_CASES = ["one tile", "block tiles", "strided tile", "off window",
              "strided off window", "masked theta", "300-beam cell",
              "unaligned rows"]
# Every sweep the system runs (:func:`kernel_shapes`), as tile cases too.
KERNEL_SHAPES = ("coarse", "fine", "dense", "loop", "loop_coarse",
                 "loop_fine", "degenerate", "loop_coarse_batch",
                 "loop_fine_batch", "grid_search")
# The sweeps of every f32-window path (the correlative matchers' coarse and
# fine sweeps, serial and batched, the grid search's) and the frontend's.
F32_SHAPES = ("coarse", "fine", "dense", "loop_coarse", "loop_fine",
              "loop_coarse_batch", "loop_fine_batch", "grid_search",
              "degenerate")
# Each case's seed is its index here.
ALL_CASES = TILE_CASES + list(KERNEL_SHAPES)


def tile_case(name):
    """NumPy inputs of one tile sweep: (win u8 [N, in_r, in_c, 2], hr, hc
    i32 and ok bool [N, T, B], origins i32 [N, K, 2], (tile_h, tile_w,
    stride), crop).  Beams lie in the crop unless the case says otherwise;
    some sit on the crop's last row and column.  A name of
    :data:`KERNEL_SHAPES` gives that sweep at the system's widths
    (:func:`kernel_shape`)."""
    if name in KERNEL_SHAPES:
        return _kernel_case(name)
    rng = np.random.default_rng(TILE_CASES.index(name) + 90)
    N, T, B, crop = 1, 12, 64, 40
    tile, origins = (10, 10, 1), np.zeros((1, 1, 2), np.int32)
    lo, hi = 0, crop
    if name == "block tiles":  # 10 of an 11 x 11 grid of 5 x 5 blocks
        N, B, crop = 2, 96, 48
        b = np.stack([rng.choice(121, 10, replace=False) for _ in range(N)])
        origins = np.stack([b // 11 * 5, b % 11 * 5], -1)
        tile = (5, 5, 1)
    elif name == "strided tile":
        tile = (11, 11, 5)
    elif name in ("off window", "strided off window"):
        N, lo, hi = 2, -3, crop + 3
        origins = np.array([[[-7, -3], [25, 28], [3, -9]],
                            [[-1, 40], [12, 2], [44, -6]]])
        tile = (5, 5, 1) if name == "off window" else (4, 6, 3)
    elif name == "300-beam cell":
        B, T = 320, 6
    elif name == "unaligned rows":  # window width 333: rows not 4-aligned
        T, B, crop = 8, 512, 324
    th, tw, stride = tile
    if name in ("off window", "strided off window"):
        in_r, in_c = crop + 6, crop + 7
    else:
        in_r = crop + int(origins[..., 0].max()) + (th - 1) * stride
        in_c = crop + int(origins[..., 1].max()) + (tw - 1) * stride
    hr = rng.integers(lo, hi, (N, T, B)).astype(np.int32)
    hc = rng.integers(lo, hi, (N, T, B)).astype(np.int32)
    hr[:, :, :4], hc[:, :, 2:6] = crop - 1, crop - 1
    ok = rng.uniform(size=(N, T, B)) < 0.9
    if name == "masked theta":
        ok[:, 3] = False
    if name == "300-beam cell":
        hr[:, :, :300], hc[:, :, :300], ok[:, :, :300] = 11, 13, True
    win = np.stack([rng.integers(0, 256, (N, in_r, in_c)),
                    255 * (rng.uniform(size=(N, in_r, in_c)) < 0.7)],
                   -1).astype(np.uint8)
    return win, hr, hc, ok, origins.astype(np.int32), tile, crop


def kernel_shapes():
    """Every sweep the system runs, as dicts of ``shape``, ``N``, ``T``,
    ``B``, ``crop``, the window ``in_r`` x ``in_c``, ``tile`` (height,
    width, stride), the tile origins ``origins`` (i32 ``[N, K, 2]``) and
    ``n_off``: the frontend's coarse sweep (stride 5, 2x2), fine sweep
    (top-32 thetas, 10x10) and dense re-run (all 208 thetas); the serial
    correlative loop detector's coarse sweep (crop 448, 11x11 at stride 5)
    and block-pruned fine sweep (top-32 thetas, 10 blocks of 5x5 of the
    11x11-block window); the same block sweep for a batch of 8 candidates
    (``loop``); 300 beams of every theta in one cell; and the batched loop
    detector's two sweeps for a batch of 8 candidates: the coarse sweep
    (``loop_coarse_batch``, one 11x11 tile at stride 5 each) and the
    block-pruned fine sweep (``loop_fine_batch``, top-32 thetas, each
    candidate its own 10 blocks); and the grid search's dense sweep
    (``grid_search``: 101 thetas, one 51 x 51 tile at stride 1, crop 448,
    the cells of a scan of config #3's world)."""
    rng = np.random.default_rng(1)

    def pick_blocks():
        b = rng.choice(121, 10, replace=False)
        return np.stack([b // 11 * 5, b % 11 * 5], -1).astype(np.int32)

    blocks = pick_blocks()
    one = np.zeros((1, 1, 2), np.int32)
    shapes = [
        dict(shape="coarse", N=1, T=208, crop=320, win=325, tile=(2, 2, 5),
             origins=one),
        dict(shape="fine", N=1, T=32, crop=320, win=329, tile=(10, 10, 1),
             origins=one),
        dict(shape="dense", N=1, T=208, crop=320, win=329, tile=(10, 10, 1),
             origins=one),
        dict(shape="loop", N=8, T=208, crop=448, win=502, tile=(5, 5, 1),
             origins=np.repeat(blocks[None], 8, axis=0)),
        dict(shape="loop_coarse", N=1, T=208, crop=448, win=498,
             tile=(11, 11, 5), origins=one),
        dict(shape="loop_fine", N=1, T=32, crop=448, win=502, tile=(5, 5, 1),
             origins=blocks[None]),
        dict(shape="degenerate", N=1, T=208, crop=320, win=329,
             tile=(10, 10, 1), origins=one),
        dict(shape="loop_coarse_batch", N=8, T=208, crop=448, win=498,
             tile=(11, 11, 5), origins=np.zeros((8, 1, 2), np.int32)),
        dict(shape="loop_fine_batch", N=8, T=32, crop=448, win=502,
             tile=(5, 5, 1),
             origins=np.stack([pick_blocks() for _ in range(8)])),
        dict(shape="grid_search", N=1, T=101, crop=448, win=498,
             tile=(51, 51, 1), origins=one),
    ]
    for s in shapes:
        s.update(B=512, in_r=s["win"], in_c=s["win"],
                 n_off=s["origins"].shape[1] * s["tile"][0] * s["tile"][1])
    return shapes


def kernel_shape(name):
    """The dict of :func:`kernel_shapes` named ``name``."""
    return next(s for s in kernel_shapes() if s["shape"] == name)


def _kernel_case(name):
    """:func:`tile_case` of a system sweep: a window of random prob levels
    with ~70 % of the cells observed, beam cells in the crop and ~95 % of
    the beams valid; the degenerate shape puts 300 valid beams of every
    theta in one cell, the grid search takes a real scan's cells
    (:func:`grid_search_cells`)."""
    s = kernel_shape(name)
    rng = np.random.default_rng(ALL_CASES.index(name))
    N, T, B, crop = s["N"], s["T"], s["B"], s["crop"]
    hr = rng.integers(0, crop, (N, T, B)).astype(np.int32)
    hc = rng.integers(0, crop, (N, T, B)).astype(np.int32)
    ok = rng.uniform(size=(N, T, B)) < 0.95
    if name == "degenerate":
        hr[:, :, :300], hc[:, :, :300], ok[:, :, :300] = 17, 23, True
    if name == "grid_search":
        hr, hc, ok = grid_search_cells()
    shape = (N, s["in_r"], s["in_c"])
    win = np.stack([rng.integers(0, 256, shape),
                    255 * (rng.uniform(size=shape) < 0.7)],
                   -1).astype(np.uint8)
    return win, hr, hc, ok, s["origins"], s["tile"], crop


def grid_search_cells():
    """Beam cells ``[1, 101, 512]`` of the grid search at the reference's
    loop window (thetas at 0.005 rad over +-0.25 rad, crop 448) for one
    scan of config #3's world after the frontend's outlier filter and
    interpolator, padded as the loop detector pads it (512 beams)."""
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import scan_to_arrays
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm
    from my_lidar_graph_slam_v2_tpu_torch.sensor.filters import (
        ScanInterpolator,
        ScanOutlierFilter,
    )

    seq = loop_sequence()
    scan = seq.scans[len(seq.scans) // 2]
    scan = ScanInterpolator(dist_scans=0.05).interpolate(
        ScanOutlierFilter(valid_range_max=20.0).remove_outliers(scan))
    a = scan_to_arrays(scan, 512, "cpu")
    T = 101
    hr, hc, valid, _, _ = csm.beam_cells(
        a.ranges, a.angles, a.mask,
        torch.as_tensor(scan.odom_pose, dtype=torch.float32),
        torch.tensor(-(T // 2), dtype=torch.int32),
        torch.tensor(0.005, dtype=torch.float32),
        torch.ones(T, dtype=torch.bool), 0.05, torch.tensor([-25.6, -25.6]),
        n_theta=T, crop_rows=448, crop_cols=448)
    return hr[None].numpy(), hc[None].numpy(), valid[None].numpy()


def f32_window(win_u8, seed, precision="highest"):
    """An f32 window ``[N, in_r, in_c, 2]`` of the shape of the u8 window
    ``win_u8``: probabilities in [1e-3, 1 - 1e-3] (the clamp of
    ``grid/values.py``) where observed, 0 elsewhere, observed as 0/1; the
    probabilities rounded as ``precision`` rounds them (``ops/csm.py:
    round_window``, spelled out here in NumPy through bf16 bits)."""
    rng = np.random.default_rng(seed)
    obs = win_u8[..., 1] > 0
    p = rng.uniform(1e-3, 1 - 1e-3, obs.shape).astype(np.float32)
    if precision != "highest":
        hi = _bf16(p)
        p = hi if precision == "fast" else (hi + _bf16(p - hi)).astype(
            np.float32)
    return np.stack([np.where(obs, p, 0), obs], -1).astype(np.float32)


# Cells below 2^-18, where the sweep rounds a prob to the nearest multiple
# of 2^-41 (ops/csm.py:round_to_fixed_point): 1e-7 and 3e-9 (rounded),
# 2^-40 (a multiple already), ties at 2^-42 and 2.5 * 2^-41 (to even),
# and 3 * 2^-43.
SMALL_CELLS = np.float32([1e-7, 3e-9, 2.0 ** -40, 2.0 ** -42, 2.5 * 2.0 ** -41,
                          3 * 2.0 ** -43])


def small_cell_window(win_u8, seed):
    """An f32 window ``[N, in_r, in_c, 2]`` of the shape of ``win_u8``
    whose observed cells each hold one of :data:`SMALL_CELLS` or, one in
    five, a prob in [1e-3, 1 - 1e-3]; observed as 0/1."""
    rng = np.random.default_rng(seed)
    obs = win_u8[..., 1] > 0
    p = np.where(rng.uniform(size=obs.shape) < 0.2,
                 rng.uniform(1e-3, 1 - 1e-3, obs.shape),
                 SMALL_CELLS[rng.integers(0, len(SMALL_CELLS), obs.shape)])
    return np.stack([np.where(obs, p, 0), obs], -1).astype(np.float32)


def _bf16(x):
    """f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


# ---------------------------------------------------------------------------
# Courses

# Keyframes of the frontend slices: at least 40, so several local maps are
# finished and compacted.
KEYFRAMES = 48


def office_sequence(keyframes=KEYFRAMES):
    """``scripts/bench_e2e.py``'s office (seed 0): laps of an 18 m office,
    181 beams to 30 m, long enough for ``keyframes`` keyframes."""
    from my_lidar_graph_slam_v2_tpu_torch.scripts.bench_e2e import (
        build_sequence,
    )

    return build_sequence(keyframes)


def loop_sequence():
    """The world of ``scripts/eval_ate.py``'s config #3: a 12 m office,
    1.3 laps at 8 cm steps, 181 beams to 12 m, odometry noise (0.05,
    0.02); the world the multi-process worker runs with ``--world
    config3``."""
    from my_lidar_graph_slam_v2_tpu_torch.parallel.worker import (
        config3_sequence,
    )

    return config3_sequence()


def async_sequence():
    """The world of ``tests/test_async_pipeline.py``: a 10 m office, 1.25
    laps at 0.3 m, 121 beams, odometry noise (0.05, 0.02), seed 22."""
    from my_lidar_graph_slam_v2_tpu_torch.parallel.worker import (
        office10_sequence,
    )

    return office10_sequence(laps=1.25, step=0.3, n_beams=121)


def soak_sequence():
    """``tests/test_soak.py``'s course: a 12 m office, 8 laps at 0.3 m, 91
    beams, odometry noise (0.02, 0.008), seed 7."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic

    return synthetic.generate(
        synthetic.World.office(seed=7, size=12.0),
        synthetic.loop_trajectory(size=12.0, laps=8.0, step=0.3),
        n_beams=91, max_range=12.0, range_noise=0.01,
        odom_noise=(0.02, 0.008), seed=7)


# ---------------------------------------------------------------------------
# Settings files, as dicts

# The launcher's: config #3's searcher, and both matchers' windows stated
# rather than left to the loader's defaults.
LAUNCHER_SETTINGS = {
    "ScanMatcherRealTimeCorrelative": {
        "SearchRangeX": 0.25, "SearchRangeY": 0.25, "SearchRangeTheta": 0.5},
    "LoopSearcherNearest": {"TravelDistThreshold": 6.0},
    "LoopDetectorRealTimeCorrelative": {
        "ScanMatcher": {"SearchRangeX": 2.5, "SearchRangeY": 2.5,
                        "SearchRangeTheta": 0.5}},
}
# The greedy-endpoint cost group of the reference's settings file.
COST_GREEDY_ENDPOINT = {"HitAndMissedDist": 0.075, "OccupancyThreshold": 0.1,
                        "KernelSize": 1, "StandardDeviation": 0.05,
                        "ScalingFactor": 1.0}
# The launcher's windows and searcher, and a loop group whose matcher is
# GridSearch at the reference file's steps, with its GreedyEndpoint cost.
GRID_SEARCH_SETTINGS = {
    "ScanMatcherRealTimeCorrelative": {
        "SearchRangeX": 0.25, "SearchRangeY": 0.25, "SearchRangeTheta": 0.5},
    "LoopSearcherNearest": {"TravelDistThreshold": 6.0},
    "Backend": {"LoopDetectorConfigGroup": "LoopDetectorGridSearch"},
    "LoopDetectorGridSearch": {
        "ScanMatcherType": "GridSearch",
        "ScanMatcher": {
            "SearchRangeX": 2.5, "SearchRangeY": 2.5, "SearchRangeTheta": 0.5,
            "SearchStepX": 0.05, "SearchStepY": 0.05,
            "SearchStepTheta": 0.005, "CostType": "GreedyEndpoint",
            "CostConfigGroup": "CostGreedyEndpoint"}},
    "CostGreedyEndpoint": COST_GREEDY_ENDPOINT,
}
# The reference file's HillClimbing group (GreedyEndpoint) as the
# frontend's matcher, no loop detection.
HILL_CLIMBING_SETTINGS = {
    "Frontend": {"LocalSlam": {
        "ScanMatcherType": "HillClimbing",
        "ScanMatcherConfigGroup": "ScanMatcherHillClimbing"}},
    "ScanMatcherHillClimbing": {
        "LinearStep": 0.1, "AngularStep": 0.1, "MaxIterations": 100,
        "MaxNumOfRefinements": 5, "CostType": "GreedyEndpoint",
        "CostConfigGroup": "CostGreedyEndpoint"},
    "CostGreedyEndpoint": COST_GREEDY_ENDPOINT,
    "Backend": {"LoopDetectorType": "Empty"},
}

# ---------------------------------------------------------------------------
# Systems: each ``make_slam(device, **factory_kw)`` builds one on ``device``

# Config #3's loop searcher.
LOOP_SEARCHER = dict(travel_dist_threshold=6.0)


def loop_slam(device, **factory_kw):
    """``create_default_slam`` with the branch-and-bound loop backend:
    nearest searcher (config #3's), the serial ``LoopDetectorBranchBound``
    at the ``BranchBoundConfig`` defaults with a linear-solver final
    matcher, and the Schur LM, inline."""
    from my_lidar_graph_slam_v2_tpu_torch.graph.optimizer import (
        OptimizerConfig,
        PoseGraphOptimizer,
    )
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import (
        LoopDetectorBranchBound,
        LoopDetectorConfig,
    )
    from my_lidar_graph_slam_v2_tpu_torch.loop.searcher import (
        LoopSearcherConfig,
        LoopSearcherNearest,
    )
    from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
        LinearSolverConfig,
        ScanMatcherLinearSolver,
    )
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.backend import (
        LidarGraphSlamBackend,
    )
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_slam,
        create_scan_matcher,
    )

    backend = LidarGraphSlamBackend(
        LoopSearcherNearest(LoopSearcherConfig(**LOOP_SEARCHER)),
        LoopDetectorBranchBound(
            LoopDetectorConfig(),
            create_scan_matcher("BranchBound", device=device),
            ScanMatcherLinearSolver(
                LinearSolverConfig(), device,
                name="LoopDetector.FinalScanMatcherLinearSolver"),
        ),
        PoseGraphOptimizer(OptimizerConfig(), device=device),
        inline=True,
    )
    return create_default_slam(device=device, backend=backend, **factory_kw)


def correlative_loop_slam(device, *, sharded=False, **factory_kw):
    """``create_default_slam`` with ``create_default_backend(sharded=...)``:
    with ``sharded=False`` the serial correlative loop detector (the fused
    CSM + GN matcher at 2.5 m x 2.5 m x 0.5 rad, T 208, crop 448), with
    ``None`` (the default backend) the batched detector, one coarse and one
    fine sweep launch for all of a backend step's candidates; config #3's
    searcher and the Schur LM, inline."""
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )

    backend = create_default_backend(device=device, sharded=sharded,
                                     searcher_overrides=LOOP_SEARCHER)
    return create_default_slam(device=device, backend=backend, **factory_kw)


def batched_branch_bound_slam(device, **factory_kw):
    """``create_default_slam`` with ``create_default_backend(
    loop_detector="BranchBound")``: branch-and-bound batched over a
    backend step's candidates at the ``LoopDetectorBranchBound`` group's
    values (the same system as :func:`loop_slam` but for the batching);
    config #3's searcher and the Schur LM, inline."""
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )

    backend = create_default_backend(device=device, loop_detector="BranchBound",
                                     searcher_overrides=LOOP_SEARCHER)
    return create_default_slam(device=device, backend=backend, **factory_kw)


def default_loop_slam(device, **factory_kw):
    """The main path: :func:`correlative_loop_slam` with the default
    (batched) backend."""
    return correlative_loop_slam(device, sharded=None, **factory_kw)


def settings_slam(settings):
    """A ``make_slam`` of ``create_slam_from_settings(settings)`` with the
    inline backend."""
    from my_lidar_graph_slam_v2_tpu_torch.config.settings import (
        create_slam_from_settings,
    )

    def make(device):
        return create_slam_from_settings(settings, device=device,
                                         inline_backend=True)

    return make


def distributed_loop_slam(device, **factory_kw):
    """``create_default_slam`` with ``create_distributed_backend`` on the
    one-device mesh ``(device,)``: config #3's searcher, the factory's
    defaults (crop 448, T 208, 512 beams, 2.5 m x 2.5 m x 0.5 rad), inline."""
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_slam,
        create_distributed_backend,
    )

    backend = create_distributed_backend([device],
                                         searcher_overrides=LOOP_SEARCHER)
    return create_default_slam(device=device, backend=backend, **factory_kw)


def multihost_loop_slam(device, **factory_kw):
    """``create_default_slam`` with ``create_multihost_backend`` on
    ``(device,)`` in the process group this process has joined, at the
    same settings as :func:`distributed_loop_slam`."""
    from my_lidar_graph_slam_v2_tpu_torch.parallel.multihost import (
        create_multihost_backend,
    )
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_slam,
    )

    backend = create_multihost_backend([device],
                                       searcher_overrides=LOOP_SEARCHER)
    return create_default_slam(device=device, backend=backend, **factory_kw)


def gather_loop_slam(device, **factory_kw):
    """The serial correlative system (:func:`correlative_loop_slam`) with
    the loop matcher's ``sweep_backend="gather"``: its fused matcher
    rebuilt at the same configs but for the backend, each sweep over the
    whole (pooled) map with no crop."""
    import dataclasses

    from my_lidar_graph_slam_v2_tpu_torch.models.fused_matcher import (
        FusedCorrelativeGNMatcher,
    )
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )

    backend = create_default_backend(device=device, sharded=False,
                                     searcher_overrides=LOOP_SEARCHER)
    det = backend.loop_detector
    m = det.scan_matcher
    det.scan_matcher = FusedCorrelativeGNMatcher(
        dataclasses.replace(m.ccfg, sweep_backend="gather"), m.lcfg, device,
        name=m.name, final_name="LoopDetector.FinalScanMatcherLinearSolver")
    return create_default_slam(device=device, backend=backend, **factory_kw)


@pytest.fixture(scope="module")
def cuda_device():
    """The card, decided when a test first asks for it (never at import or
    collection): without one the test skips.  TF32 off, as the port's
    exact f32 products need."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
