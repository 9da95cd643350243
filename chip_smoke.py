#!/usr/bin/env python3
"""Start the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; no phase swallows its own failure):

1. Device: requires CUDA (there is no CPU fallback) and prints the card's
   name and power limit as ``nvidia-smi`` reports them.
2. Build: compiles ``csrc/csm_sweep.cu``, ``csrc/csm_sweep_f32.cu`` and
   ``csrc/hit_images.cu`` with nvcc for sm_90a from the checkout's
   sources, all at once, and prints the build times and ptxas reports,
   and each kernel's count of f32-to-f64 converts (``F2F.F64.F32`` in
   ``cuobjdump -sass``): the f32 sweep kernels must have none.
3. Kernels against plain: the CSM sweep kernel must be ``torch.equal`` to
   its plain PyTorch version at every sweep the system runs
   (:func:`kernel_shapes`: the frontend's coarse, fine and dense sweeps,
   the serial correlative loop detector's crop-448 coarse and block
   sweeps, a block sweep of all 208 thetas for a batch of 8, 300 beams in
   one cell, the batched loop detector's coarse and block sweeps for a
   batch of 8, and the grid search's one 51 x 51 tile over 101 thetas at
   crop 448 on a scan of config #3's world); the hit-image kernel likewise at branch-and-bound's shape, the
   frontend crop and a degenerate shape.  Each kernel's device time comes
   from CUDA-graph replays (:func:`_graph_ms`), beside its bound, the
   plain version's time and one library call's (``F.conv2d`` of the
   window with hit-image filters for a one-tile sweep, ``torch.bincount``
   for the hit images).  The f32 form of the sweep likewise at the
   frontend's, the correlative loop matchers' (serial and batched), the
   grid search's and the degenerate shapes, on windows from a seeded f32
   map rounded as each precision rounds them, the kernel's and the plain
   result also unchanged when the beams are permuted (``F.conv2d`` f32 its
   library call; the time is the pack's and the sweep's), its pack kernel
   ``torch.equal`` to the plain pack at each shape, the sweep equal to
   the plain version on a window of cells below 2^-18 at each shape, and
   the sweep at 2,048 beams all reading 1.0 (the fixed point's edge; no
   time).
4. The frontend slice: ``create_default_slam(device="cuda")`` at the
   factory defaults drives the synthetic office sequence for >= 40
   keyframes; the same sequence runs through the port on the CPU (plain
   sweep).  Same keyframe count, poses within one grid cell, ATE below raw
   odometry, and at least two sweep launches per matched keyframe.
5. The branch-and-bound loop slice: the same factory with the
   branch-and-bound loop backend (``LoopDetectorBranchBound`` at the
   ``BranchBoundConfig`` defaults, Schur LM) on the world of
   ``scripts/eval_ate.py``'s config #3, on the card and through the port
   on the CPU.  At least one loop edge, one hit-image launch per
   branch-and-bound match, the same keyframes and loop edges on both
   devices, poses within tolerance, ATE below raw odometry.  Times per
   match and per backend step come from an unfenced run after a warm-up;
   a separate fenced run gives the per-stage breakdown of the matches.
6. The correlative loop slice: the same world through the port's default
   backend, ``create_default_backend(sharded=False)`` (the serial
   correlative loop detector at crop 448), on the card and on the CPU:
   the same keyframes and loop edges, bitwise-equal poses, at least one
   loop edge, ATE below odometry's; prints its sweep launches and the
   median ms per loop match.
7. The default backend: the same world through
   ``create_default_backend()``, the batched correlative detector
   (``parallel/loop_sharded.py``), on the card (after a warm-up run) and
   on the CPU: the same keyframes and loop edges, bitwise-equal poses, at
   least one loop edge, ATE below odometry's, and exactly two sweep
   launches per backend step with candidates plus two per dense re-run;
   prints the batch sizes and the median ms per ``detect`` and per
   backend step beside phase 6's.
8. The launcher: config #3's world written as a Carmen log, then
   ``pipeline/launcher.py``'s ``main`` with a settings file and no
   ``--device`` (so CUDA); the saved pose graph read back has phase 7's
   keyframe count, a loop edge and ATE below odometry's, and the PNG and
   metrics JSON parse.
9. The GridSearch loop slice: config #3's world through
   ``create_slam_from_settings`` (inline) with the fused frontend and a
   loop group whose matcher is GridSearch at the reference's steps
   (2.5 m x 2.5 m x 0.5 rad, 0.05 / 0.05 / 0.005) with the GreedyEndpoint
   cost, on the card and on the CPU: the same keyframes and loop edges,
   bitwise-equal poses, at least one loop edge, ATE below odometry's and
   exactly one sweep launch per grid-search match; prints the median ms
   per match and per backend step.
10. The HillClimbing frontend: the office sequence of phase 4 through
    ``create_slam_from_settings`` with the HillClimbing matcher and its
    reference cost, GreedyEndpoint, and the Empty loop detector, on the
    card and on the CPU: the same keyframes, bitwise-equal finite poses,
    no sweep launch, ATE below odometry's; prints ms, climbing iterations
    and fetches per keyframe and the ATE beside odometry's.
11. The multi-device layer on config #3's world at the factory defaults,
    against phase 7's run in this process: (a) ``create_distributed_backend``
    on a one-device mesh, on the card and on the CPU; (b)
    ``create_multihost_backend`` in this process in an NCCL group of one
    rank, and on the CPU in a gloo group of one rank; each with phase 7's
    keyframes and loop edges, CUDA poses bitwise equal to the CPU's,
    poses within ``DIST_TOL`` of phase 7's, two sweep launches per
    ``detect`` plus two per dense re-run, and the LM's ms per call beside
    phase 7's; (c) two ``parallel/worker.py`` processes (gloo) on the one
    card: both trajectories bitwise equal, phase 7's keyframes and loop
    edges, ATE within 0.005 m of phase 7's, each rank's rasterized maps
    its own, the owner-retention invariants, and both ranks' sharded
    global maps with the observed cells of (a)'s run's map built in one
    process; prints each rank's wall time, sweep launches and collectives
    per backend step.
12. Head to head: the committed logs ``h2h/synth7.clf``, ``synth11.clf``
    and the 997-keyframe ``synth3.clf`` through the port's launcher on the
    card (``scripts/head_to_head.py:run_ours``, a subprocess, with the
    reference binary's settings ``h2h/settings_lm.json``): the binary's
    nodes, its loop edges (synth3: at least as many), ATE at or below the
    binary's and at most 0.005 m above the JAX package's artifact; prints
    each log's wall time, sweep launches and peak device memory.
13. The measurement scripts: ``scripts/bench_csm.py`` (the C++ baseline's
    live rate in its subprocess, matches/s at batch 8 and 16 and the stage
    ms; the card's batch-8 outputs equal to the CPU's bit for bit),
    ``scripts/eval_ate.py``'s four configurations (the keyframes of
    ``results_ate.json``, ATE below odometry's, loop edges for #2-#4, and
    for #3 a hit-image launch per branch-and-bound match) and
    ``scripts/bench_e2e.py`` at 200 keyframes with the threaded backend
    (ATE below odometry's), ``eval_bb_pyramid`` at the JAX script's sizes
    (branch-and-bound's score the dense sweep's gated argmax on both
    maps), ``eval_scaling`` on one card and ``eval_scaling_pipeline``
    (P = 1 and 2 gloo workers on the card, the same ATE and trajectory).
14. f32 maps at full width: phase 7's loop queries matched against their
    local maps as f32 probability rasters (1024 x 1024 at 5 cm) by the
    batched detector's correlative config at "highest" and "split" and
    with the gather backend (the whole map as the window), the grid
    search at phase 9's steps and branch-and-bound at phase 5's config:
    ms per match, f32 and u8 sweep launches per match (2 f32 per
    correlative match, 1 per grid-search match, none u8; one pack launch
    per f32 sweep) and found flags;
    the same found flags as the u8 match of each query and poses within
    0.05 m / 0.02 rad of it, and on the CPU for 4 queries bitwise-equal
    poses; those 4 queries again on their rasters with every free cell at
    1e-7 (below 2^-18), every matcher on the card and the CPU, poses
    bitwise equal.
15. The gather backend: phase 6's system with ``sweep_backend="gather"``
    on the card and the CPU: phase 6's keyframes, a loop edge, bitwise
    poses, ATE below odometry's and within 0.005 m of phase 6's; loop
    edges and ms per match beside phase 6's.
16. The scatter rasterizer: phase 4's slice with
    ``rasterize_backend="scatter"`` on the card and the CPU: phase 4's
    keyframes, bitwise poses, ATE within 0.005 m of phase 4's; ms per
    keyframe beside phase 4's.
17. The runtime: (a) the world of ``tests/test_async_pipeline.py``
    inline on the card and the CPU (bitwise-equal poses, the same loop
    edges), then with the backend on its worker thread on the card (a
    worker step, ATE below 0.12 m; its optimization and backpressure waits
    printed); (b) the soak of ``tests/test_soak.py`` on the main path at
    the factory widths (the batched detector, a 16-entry map cache):
    >= 300 keyframes, > 64 local maps, >= 10 loop edges, ATE below
    odometry's (the JAX test's 0.30 m and half of odometry's printed;
    ROADMAP 3.17), no out-of-extent hit, cache evictions and hits,
    host RSS growth below 1,500 MB, no kernel built during the run, the
    same sweep launches in every frontend match, and device-memory growth
    within a bound computed before the run; prints ms per keyframe, the
    backend-step and ``detect`` medians and the device-memory curve.
18. Prints the kernel summary line (every number of it measured or, for
    ``bound_ms``, computed in this run), the nvidia-smi line, and last
    ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# The peaks behind every bound_ms and the bound of a sweep are shared with
# the port's measurement scripts; build_sequence is bench_e2e's office
# sequence.
from my_lidar_graph_slam_v2_tpu_torch.scripts.bench_e2e import build_sequence
from my_lidar_graph_slam_v2_tpu_torch.scripts.common import (
    F32_OPS_PER_S,
    bound as _bound,
    nvidia_smi as _nvidia_smi,
    sweep_bound,
)

# Tolerances of the CUDA-vs-CPU slice comparison, fixed before any run.
# Keyframes are gated by odometry alone, so their count must be equal.
# Poses: one grid cell (0.05 m) in x and y, one theta search step at 20 m
# range (2 asin(0.025 / 20) = 0.0025 rad) in heading.  f32 rounding that
# differs between the card and the CPU (trig, sigmoid, summation order)
# can move a CSM argmax by one search cell at most, and GN refinement
# pulls it back; a larger disagreement is a fault.
POSE_TOL_XY = 0.05
POSE_TOL_THETA = 0.0025
TIMED_RUNS = 20
# Keyframes of the slice's run: at least 40 so several local maps are
# finished and compacted.
KEYFRAMES = 48
# The loop slice's CUDA-vs-CPU tolerances, fixed before its first run: one
# grid cell in x and y, two theta search steps at 20 m range in heading.
# Both devices take the same exact integer scores; f32 trig may move a
# beam's cell, and the GN refinement and the f32 LM solve (cuSOLVER and
# LAPACK) round differently after each loop closure.
LOOP_TOL_XY = 0.05
LOOP_TOL_THETA = 0.005
# Kernel launches captured in one CUDA graph for a device time.
GRAPH_LAUNCHES = 20


def _graph_ms(fn, launches=GRAPH_LAUNCHES, replays=TIMED_RUNS):
    """Device ms per call of ``fn``: ``launches`` calls captured in one
    CUDA graph, the graph replayed between two events ``replays`` times,
    the median replay divided by ``launches``.  The wrapper's host work
    (argument checks, allocation, the ctypes call) is not replayed, so
    this is the kernels' device time with the graph's gaps between them.
    The inputs stay in L2 between launches, as a window just cut does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def _events_ms(fn, calls=TIMED_RUNS, warmup=3):
    """ms per call of ``fn`` over ``calls`` back-to-back calls between two
    events: device time where the device is the slower side, the host's
    enqueue time where the host is (the plain versions and library calls
    at small shapes; some of them synchronize)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


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

    seq = build_loop_sequence()
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


def sweep_inputs(rng, s):
    """NumPy inputs of shape ``s``: the u8 window ``[N, 2, in_r, in_c]``
    (prob levels, observed * 255; channels first), beam cells in the crop
    and a mask with ~95 % of the beams valid; the degenerate shape puts
    300 valid beams of every theta in one cell, and the grid search takes
    a real scan's cells (:func:`grid_search_cells`)."""
    N, T, B, crop = s["N"], s["T"], s["B"], s["crop"]
    hr = rng.integers(0, crop, (N, T, B)).astype(np.int32)
    hc = rng.integers(0, crop, (N, T, B)).astype(np.int32)
    ok = rng.uniform(size=(N, T, B)) < 0.95
    if s["shape"] == "degenerate":
        hr[:, :, :300], hc[:, :, :300], ok[:, :, :300] = 17, 23, True
    if s["shape"] == "grid_search":
        hr, hc, ok = grid_search_cells()
    prob = rng.integers(0, 256, (N, 1, s["in_r"], s["in_c"]))
    obs = 255 * (rng.uniform(size=(N, 1, s["in_r"], s["in_c"])) < 0.7)
    win = np.concatenate([prob, obs], axis=1).astype(np.uint8)
    return win, hr, hc, ok


def sweep_library_call(win, hr, hc, ok, s):
    """One PyTorch call for a sweep of one tile at the window's origin:
    ``F.conv2d`` of the f32 windows (the two channels as the batch, the N
    candidates as the channels) with the prebuilt hit images as T filters
    per candidate (``groups=N``) at the tile's stride (cuDNN TF32 off);
    None for sweeps of tile lists, which no one call computes.  Returns the
    call and the unscaled scores it gives (``[N, T, 2, n_off]``), or (None,
    None)."""
    import torch.nn.functional as F

    from my_lidar_graph_slam_v2_tpu_torch.ops import csm

    if s["origins"].shape[1] != 1 or s["origins"].any():
        return None, None
    N, T = s["N"], s["T"]
    th, tw, stride = s["tile"]
    hits = torch.cat([csm.hit_images_plain(
        torch.where(ok[n], hr[n], -1), hc[n],
        crop_rows=s["crop"], crop_cols=s["crop"]) for n in range(N)])[:, None]
    x = win.transpose(0, 1).to(torch.float32)

    def call():
        return F.conv2d(x, hits, stride=stride, groups=N)

    got = call()[:, :, :th, :tw].reshape(2, N, T, -1).permute(1, 2, 0, 3)
    return call, got


def check_kernel(device):
    """Phase 3: the sweep kernel vs its plain version at every shape of
    :func:`kernel_shapes`; device time, plain and library times, bound."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda, quant

    rng = np.random.default_rng(0)
    out = []
    for s in kernel_shapes():
        win, hr, hc, ok = (torch.as_tensor(a, device=device)
                           for a in sweep_inputs(rng, s))
        th, tw, stride = s["tile"]
        kw = dict(tile_h=th, tile_w=tw, stride=stride)
        args = (win.permute(0, 2, 3, 1).contiguous(), hr, hc, ok,
                torch.as_tensor(s["origins"], device=device))
        got = csm_cuda.csm_sweep(*args, **kw)
        ref = csm.sweep_tiles_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"kernel != plain at shape {s['shape']}")
        lib, lib_out = sweep_library_call(win, hr, hc, ok, s)
        bound_ms, bound_by = sweep_bound(s, ok)
        ms = _graph_ms(lambda: csm_cuda.csm_sweep(*args, **kw))
        row = dict(
            shape=s["shape"], N=s["N"], T=s["T"], B=s["B"], crop=s["crop"],
            tile=list(s["tile"]), tiles=int(s["origins"].shape[1]),
            n_off=s["n_off"], max_abs_err=float((got - ref).abs().max()),
            ms=ms, plain_ms=_events_ms(
                lambda: csm.sweep_tiles_plain(*args, **kw)),
            bound_ms=bound_ms, bound_by=bound_by, pct_of_bound=100 * bound_ms / ms,
            library_ms=None if lib is None else _events_ms(lib),
            library_max_abs_err=None if lib is None else float(
                (lib_out * float(quant.INV255) - got).abs().max()),
        )
        print(f"kernel {json.dumps(row)}", flush=True)
        out.append(row)
    return out


# Phase 3, the f32 form: the sweeps of every f32-window path (the
# correlative matchers' coarse and fine sweeps, serial and batched, the grid
# search's) and the frontend's shapes, as the u8 rows.
F32_SHAPES = ("coarse", "fine", "dense", "loop_coarse", "loop_fine",
              "loop_coarse_batch", "loop_fine_batch", "grid_search",
              "degenerate")


# Cells below 2^-18 (ROADMAP 3.15): the sweep rounds each to the nearest
# multiple of 2^-41 (ops/csm.py:round_to_fixed_point), the kernel's pack
# and the plain version alike: 1e-7 and 3e-9 (rounded), 2^-40 (already a
# multiple), ties at 2^-42 and 2.5 * 2^-41 (to even) and 3 * 2^-43.
SMALL_CELLS = np.float32([1e-7, 3e-9, 2.0 ** -40, 2.0 ** -42,
                          2.5 * 2.0 ** -41, 3 * 2.0 ** -43])


def small_cell_window(rng, win_u8):
    """An f32 window ``[N, in_r, in_c, 2]`` (channels last) of the u8
    window's observed cells, each one of :data:`SMALL_CELLS` or, one in
    five, a probability uniform in [1e-3, 1 - 1e-3] (0 where
    unobserved), unrounded."""
    obs = win_u8[:, 1] > 0
    p = np.where(rng.uniform(size=obs.shape) < 0.2,
                 rng.uniform(1e-3, 1 - 1e-3, obs.shape),
                 SMALL_CELLS[rng.integers(0, len(SMALL_CELLS), obs.shape)])
    return np.stack([np.where(obs, p, 0), obs], -1).astype(np.float32)


def f32_raw_window(rng, win_u8):
    """An f32 window ``[N, in_r, in_c, 2]`` (channels last) of the u8
    window's observed cells, each with a probability drawn uniform in
    [1e-3, 1 - 1e-3] (0 where unobserved), before any rounding."""
    obs = win_u8[:, 1] > 0
    p = np.where(obs, rng.uniform(1e-3, 1 - 1e-3, obs.shape), 0)
    return np.stack([p, obs], -1).astype(np.float32)


def check_f32_kernel(device):
    """Phase 3, f32 windows: the f32 sweep kernel vs its plain version
    (``torch.equal``) at :data:`F32_SHAPES`, on windows from a seeded f32
    map (probabilities in [1e-3, 1 - 1e-3] where observed) rounded as each
    precision rounds them; the kernel's and the plain result unchanged
    when the beams are permuted; the pack kernel equal to the plain pack;
    the kernel equal to the plain version on a window of cells below 2^-18
    (:func:`small_cell_window`, as it is and already rounded to multiples
    of 2^-41); device ms of the "split" window from CUDA-graph replays
    (the whole wrapper: pack and sweep; the pack alone as ``pack``),
    beside its bound, the plain version's ms and ``F.conv2d`` f32's; then
    the sweep at 2,048 beams all reading 1.0 (:func:`check_f32_all_ones`)."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda

    rng = np.random.default_rng(3)
    small_rng = np.random.default_rng(315)
    gen = torch.Generator().manual_seed(3)
    out = []
    for s in kernel_shapes():
        if s["shape"] not in F32_SHAPES:
            continue
        win_u8, hr, hc, ok = sweep_inputs(rng, s)
        raw = torch.as_tensor(f32_raw_window(rng, win_u8), device=device)
        hr, hc, ok = (torch.as_tensor(a, device=device) for a in (hr, hc, ok))
        origins = torch.as_tensor(s["origins"], device=device)
        th, tw, stride = s["tile"]
        kw = dict(tile_h=th, tile_w=tw, stride=stride)
        for precision in ("highest", "fast", "split"):
            win = csm.round_window(raw, precision).contiguous()
            args = (win, hr, hc, ok, origins)
            got = csm_cuda.csm_sweep_f32(*args, **kw)
            ref = csm.sweep_tiles_plain(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"f32 kernel != plain at shape {s['shape']}, {precision}")
        perm = torch.randperm(s["B"], generator=gen).to(device)
        beams = (hr[..., perm], hc[..., perm], ok[..., perm])
        permuted = csm.sweep_tiles_plain(win, *beams, origins, **kw)
        permuted_kernel = csm_cuda.csm_sweep_f32(win, *beams, origins, **kw)
        if not (torch.equal(permuted, ref) and torch.equal(permuted_kernel,
                                                           ref)):
            raise AssertionError(
                f"f32 sweep depends on the beam order at {s['shape']}")
        packed = csm_cuda.csm_pack_f32(win)
        packed_ref = csm.pack_f32_window_plain(win)
        if not torch.equal(packed, packed_ref):
            raise AssertionError(f"f32 pack != plain at shape {s['shape']}")
        small = torch.as_tensor(small_cell_window(small_rng, win_u8),
                                device=device)
        for w in (small, csm.round_to_fixed_point(small)):
            sargs = (w, hr, hc, ok, origins)
            got_s = csm_cuda.csm_sweep_f32(*sargs, **kw)
            ref_s = csm.sweep_tiles_plain(*sargs, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got_s, ref_s):
                raise AssertionError(
                    f"f32 kernel != plain below 2^-18 at shape {s['shape']}")
        lib, lib_out = sweep_library_call(win.permute(0, 3, 1, 2), hr, hc, ok,
                                          s)
        bound_ms, bound_by = sweep_bound(s, ok, f32=True)
        ms = _graph_ms(lambda: csm_cuda.csm_sweep_f32(*args, **kw))
        pack_ms = _graph_ms(lambda: csm_cuda.csm_pack_f32(win))
        # The pack reads 8 B and writes 8 B a cell, one f32 multiply each.
        pack_bound_ms, pack_bound_by = _bound(
            16 * packed.numel(), packed.numel(), F32_OPS_PER_S)
        row = dict(
            shape=s["shape"], N=s["N"], T=s["T"], B=s["B"], crop=s["crop"],
            tile=list(s["tile"]), tiles=int(s["origins"].shape[1]),
            n_off=s["n_off"], precisions_checked=3, beams_permuted=True,
            below_2_18_equal=True,
            max_abs_err=float((got - ref).abs().max()), ms=ms,
            plain_ms=_events_ms(lambda: csm.sweep_tiles_plain(*args, **kw)),
            bound_ms=bound_ms, bound_by=bound_by,
            pct_of_bound=100 * bound_ms / ms,
            library_ms=None if lib is None else _events_ms(lib),
            library_max_abs_err=None if lib is None else float(
                (lib_out - got).abs().max()),
            pack=dict(
                ms=pack_ms, max_abs_err=float(
                    (packed - packed_ref).abs().max()),
                plain_ms=_events_ms(lambda: csm.pack_f32_window_plain(win)),
                bound_ms=pack_bound_ms, bound_by=pack_bound_by,
                pct_of_bound=100 * pack_bound_ms / pack_ms, library_ms=None),
        )
        print(f"f32_kernel {json.dumps(row)}", flush=True)
        out.append(row)
    check_f32_all_ones(device)
    return out


def check_f32_all_ones(device):
    """Phase 3, the f32 fixed point's edge: 2,048 beams (the most the
    kernel takes), every one valid and every offset on a window of 1.0
    observed, so each output sums m = 2048 * 2^41 = 2^52 and each warp's
    observed count is 128; the kernel equal to the plain version and both
    2048.0, for a stride-1 and a strided tile.  No time."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda

    rng = np.random.default_rng(2048)
    N, T, B = 2, 3, 2048
    win = torch.ones((N, 64, 64, 2), dtype=torch.float32, device=device)
    hr, hc = (torch.as_tensor(rng.integers(0, 10, (N, T, B)).astype(np.int32),
                              device=device) for _ in range(2))
    ok = torch.ones((N, T, B), dtype=torch.bool, device=device)
    origins = torch.zeros((N, 1, 2), dtype=torch.int32, device=device)
    for th, tw, stride in ((10, 10, 1), (11, 11, 5)):
        kw = dict(tile_h=th, tile_w=tw, stride=stride)
        got = csm_cuda.csm_sweep_f32(win, hr, hc, ok, origins, **kw)
        ref = csm.sweep_tiles_plain(win, hr, hc, ok, origins, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got, ref)
                and torch.equal(ref, torch.full_like(ref, 2048.0))):
            raise AssertionError(f"f32 kernel at 2,048 beams of 1.0, tile "
                                 f"{(th, tw, stride)}: {got.unique()}")
    print(f"f32_all_ones {json.dumps(dict(N=N, T=T, B=B, equal=True))}",
          flush=True)


def run_slice(device, seq, make_slam=None, **factory_kw):
    """Drive the port's frontend over ``seq`` on ``device``, the system of
    ``create_default_slam`` or of ``make_slam(device)``; returns the
    trajectory, ground truth at keyframes, per-keyframe host times and the
    frontend's matcher."""
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import create_default_slam

    device = torch.device(device)
    cuda = device.type == "cuda"
    slam = (make_slam(device) if make_slam
            else create_default_slam(device=device, **factory_kw))
    gt, kf_ms = [], []
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for scan, g in zip(seq.scans, seq.ground_truth):
        t = time.perf_counter()
        if slam.process_scan(scan, scan.odom_pose):
            kf_ms.append((time.perf_counter() - t) * 1e3)
            gt.append(g)
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    slam.stop_backend()
    matcher = slam.frontend.scan_matcher
    return dict(est=slam.get_trajectory(), gt=np.asarray(gt), wall=wall,
                kf_ms=kf_ms, fetches=matcher.host_fetches, matcher=matcher)


def _sync_sites(fn):
    """Run ``fn`` with PyTorch's sync debug mode on; count the warnings of
    synchronizing CUDA operations by the source line that caused them."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def check_slice(device):
    """Phase 4: the factory-default frontend slice on the card vs the CPU.

    A short warm-up run on another sequence first pays the one-time costs
    (CUDA context, cuBLAS/cuSOLVER handles, allocator growth); the timed
    run follows with the launch count reset just before it; a third run
    of the same sequence counts synchronizing operations (the debug mode
    adds host work, so it is not the timed run)."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    seq = build_sequence(KEYFRAMES)
    warm = run_slice(device, build_sequence(4, seed=1))
    torch.cuda.reset_peak_memory_stats(device)
    csm_cuda.LAUNCHES = 0
    gpu = run_slice(device, seq)
    launches = csm_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated(device)
    sites = _sync_sites(lambda: run_slice(device, seq))
    syncs = sum(sites.values())
    cpu = run_slice("cpu", seq)

    n_kf = len(gpu["est"])
    matched = n_kf - 1
    d = np.abs(gpu["est"] - cpu["est"]) if len(cpu["est"]) == n_kf else None
    ate = synthetic.ate_rmse(gpu["est"], gpu["gt"])
    ate_cpu = synthetic.ate_rmse(cpu["est"], cpu["gt"])
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth)
    steady = gpu["kf_ms"][1:]
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]), scans=len(seq.scans),
        warmup_keyframes=len(warm["est"]), warmup_wall_s=warm["wall"],
        wall_s=gpu["wall"], keyframes_per_s=n_kf / gpu["wall"],
        ms_per_keyframe=1e3 * gpu["wall"] / n_kf,
        keyframe_ms_median=statistics.median(steady),
        keyframe_ms_p90=float(np.percentile(steady, 90)),
        cpu_wall_s=cpu["wall"], cpu_ms_per_keyframe=1e3 * cpu["wall"] / n_kf,
        launches=launches, launches_per_matched_keyframe=launches / matched,
        host_fetches_per_keyframe=gpu["fetches"] / matched,
        sync_warnings_per_keyframe=syncs / n_kf,
        sync_sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])[:10]),
        peak_mem_bytes=peak,
        ate_m=ate, ate_cpu_m=ate_cpu, ate_odom_m=ate_odom,
        max_dxy_m=None if d is None else float(d[:, :2].max()),
        max_dtheta_rad=None if d is None else float(d[:, 2].max()),
    )
    print(f"slice {json.dumps(stats)}", flush=True)
    if n_kf < 40:
        raise AssertionError(f"only {n_kf} keyframes (need >= 40)")
    if d is None:
        raise AssertionError(f"keyframes differ: cuda {n_kf}, cpu {len(cpu['est'])}")
    if stats["max_dxy_m"] > POSE_TOL_XY or stats["max_dtheta_rad"] > POSE_TOL_THETA:
        raise AssertionError(
            f"cuda and cpu poses differ beyond tolerance: dxy "
            f"{stats['max_dxy_m']} (tol {POSE_TOL_XY}), dtheta "
            f"{stats['max_dtheta_rad']} (tol {POSE_TOL_THETA})"
        )
    if not np.all(np.isfinite(gpu["est"])) or not ate < ate_odom:
        raise AssertionError(f"ATE {ate} does not beat odometry {ate_odom}")
    if launches < 2 * matched:
        raise AssertionError(
            f"{launches} kernel launches for {matched} matched keyframes"
        )
    return stats, launches


def check_hit_kernel(device):
    """Phase 3, hit images: kernel vs plain on the card at
    branch-and-bound's shape (T 208, B 512, crop 448), at the frontend
    crop 320, and with 300 beams of every theta in one cell; about 5% of
    the pairs dropped as row -1 and 5% with an out-of-crop column."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, hit_images_cuda

    rng = np.random.default_rng(2)
    out = []
    for name, T, B, crop in (("branch_bound", 208, 512, 448),
                             ("frontend_crop", 208, 512, 320),
                             ("degenerate", 208, 512, 448)):
        rows = rng.integers(0, crop, (T, B)).astype(np.int32)
        cols = rng.integers(0, crop, (T, B)).astype(np.int32)
        u = rng.uniform(size=(T, B))
        rows[u < 0.05] = -1
        cols[(u >= 0.05) & (u < 0.1)] = crop + 3
        if name == "degenerate":
            rows[:, :300], cols[:, :300] = 17, 23
        rows, cols = (torch.as_tensor(a, device=device) for a in (rows, cols))
        kw = dict(crop_rows=crop, crop_cols=crop)
        got = hit_images_cuda.hit_images(rows, cols, **kw)
        ref = csm.hit_images_plain(rows, cols, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"hit-image kernel != plain at shape {name}")
        if name == "degenerate" and float(got[:, 17, 23].min()) < 300:
            raise AssertionError("degenerate cell lost counts")
        err = float((got - ref).abs().max())
        ms = _graph_ms(lambda: hit_images_cuda.hit_images(rows, cols, **kw))
        plain_ms = _events_ms(lambda: csm.hit_images_plain(rows, cols, **kw))
        # library: one torch.bincount of the flat (theta, row, col) keys
        inside = (rows >= 0) & (rows < crop) & (cols >= 0) & (cols < crop)
        t = torch.arange(T, device=device)[:, None]
        keys = ((t * crop + rows) * crop + cols)[inside]
        lib = torch.bincount(keys, minlength=T * crop * crop)
        if not torch.equal(lib.reshape(T, crop, crop).to(torch.float32), ref):
            raise AssertionError(f"bincount != plain at shape {name}")
        library_ms = _events_ms(
            lambda: torch.bincount(keys, minlength=T * crop * crop))
        # bytes: rows and cols read, the f32 image written; one f32 add
        # per pair in the crop
        bound_ms, bound_by = _bound(T * B * 8 + T * crop * crop * 4,
                                    int(inside.sum()), F32_OPS_PER_S)
        row = dict(shape=name, T=T, B=B, crop=crop, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   pct_of_bound=100 * bound_ms / ms, library_ms=library_ms)
        print(f"hit_kernel {json.dumps(row)}", flush=True)
        out.append(row)
    return out


def build_loop_sequence(seed: int = 11, laps: float = 1.3):
    """The world of ``scripts/eval_ate.py``'s config #3: a 12 m office,
    1.3 laps at 8 cm steps, 181 beams to 12 m, odometry noise
    (0.05, 0.02); the world the multi-process worker runs with ``--world
    config3``."""
    from my_lidar_graph_slam_v2_tpu_torch.parallel.worker import (
        config3_sequence,
    )

    return config3_sequence(seed, laps)


def loop_slam(device, **factory_kw):
    """``create_default_slam`` with the branch-and-bound loop backend:
    nearest searcher (travel threshold 6 m, as config #3), the serial
    ``LoopDetectorBranchBound`` at the ``BranchBoundConfig`` defaults with
    a linear-solver final matcher, and the Schur LM, inline."""
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
        LoopSearcherNearest(LoopSearcherConfig(travel_dist_threshold=6.0)),
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
    fine sweep launch for all of a backend step's candidates; nearest
    searcher (travel threshold 6 m, as config #3) and the Schur LM,
    inline."""
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )

    backend = create_default_backend(
        device=device, sharded=sharded,
        searcher_overrides=dict(travel_dist_threshold=6.0))
    return create_default_slam(device=device, backend=backend, **factory_kw)


def default_loop_slam(device, **factory_kw):
    return correlative_loop_slam(device, sharded=None, **factory_kw)


class StageTimer:
    """Host times and calls of named callables while the context is open,
    each fenced by device syncs on CUDA if its stage says so; restores
    them on exit.  A stage's name may be a function of the call's (args,
    kwargs).  With ``count`` (a function returning a running count, such
    as a kernel's launches) each stage also sums the count's growth over
    its calls."""

    def __init__(self, device, stages, count=None):
        self.device = torch.device(device)
        self.stages = stages  # (owner, attribute, name, fenced)
        self.count = count
        self.acc = {}
        self._saved = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        for owner, attr, name, fenced in self.stages:
            fn = getattr(owner, attr)

            def timed(*args, _fn=fn, _name=name, _fenced=fenced, **kw):
                if callable(_name):
                    _name = _name(args, kw)
                if _fenced:
                    self._sync()
                n0 = self.count() if self.count else None
                t = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    if _fenced:
                        self._sync()
                    calls, ms, n = self.acc.get(_name, (0, [], 0))
                    ms.append((time.perf_counter() - t) * 1e3)
                    if n0 is not None:
                        n += self.count() - n0
                    self.acc[_name] = (calls + 1, ms, n)

            self._saved.append((owner, attr, fn))
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        return False


def _loop_stages():
    """The stages of a branch-and-bound match and of a backend step, as
    (owner, attribute, name, fenced).  The match's own fetches
    synchronize, so the whole match and the final matcher need no fence;
    the pieces inside the core are fenced."""
    from my_lidar_graph_slam_v2_tpu_torch.graph import optimizer
    from my_lidar_graph_slam_v2_tpu_torch.matching import (
        branch_bound,
        linear_solver,
    )
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, pool
    from my_lidar_graph_slam_v2_tpu_torch.pipeline import backend

    return [
        (backend.LidarGraphSlamBackend, "run_step", "backend step", False),
        (branch_bound.ScanMatcherBranchBound, "optimize_pose", "bb match",
         False),
        (pool, "pyramid", "pyramid (once per map)", True),
        (csm, "build_hit_images", "hit images", True),
        (csm, "sweep_from_hits",
         lambda a, kw: "bound sweep" if kw["stride"] > 1 else "block sweeps",
         True),
        (branch_bound, "cost_at", "cost at winner", True),
        (branch_bound, "covariance_at", "covariance at winner", True),
        (branch_bound, "fetch", "bb fetches", False),
        (linear_solver.ScanMatcherLinearSolver, "optimize_pose",
         "final matcher", False),
        (optimizer.PoseGraphOptimizer, "optimize", "LM (Schur)", False),
    ]


def run_loop_slice(device, seq, *, stages=(), make_slam=loop_slam, count=None,
                   **factory_kw):
    """Drive a loop slice (``make_slam``: :func:`loop_slam`,
    :func:`correlative_loop_slam` or :func:`default_loop_slam`) over
    ``seq`` on ``device``; returns the trajectory, loop edges, ground truth
    at keyframes, the loop matcher (the batched detector itself, which has
    none) and the times of ``stages`` (see :func:`_loop_stages`; a
    callable gets the slam object and returns them)."""
    device = torch.device(device)
    slam = make_slam(device, **factory_kw)
    if callable(stages):
        stages = stages(slam)
    timer = StageTimer(device, stages, count)
    gt = []
    with timer:
        t0 = time.perf_counter()
        for scan, g in zip(seq.scans, seq.ground_truth):
            if slam.process_scan(scan, scan.odom_pose):
                gt.append(g)
        slam.stop_backend()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    detector = slam.backend.loop_detector
    matcher = getattr(detector, "scan_matcher", detector)
    return dict(
        est=slam.get_trajectory(), gt=np.asarray(gt), wall=wall, slam=slam,
        loops=[(e.local_map_node_id, e.scan_node_id)
               for e in slam.pose_graph.edges if e.is_loop],
        matcher=matcher, matches=getattr(matcher, "matches", None),
        blocks=getattr(matcher, "blocks_swept", None),
        fetches=matcher.host_fetches, stages=timer.acc,
    )


def _stage_summary(acc, matches):
    """Per stage: calls, calls and ms per match, median ms per call, and
    the counted launches per call where the run counted them."""
    out = {}
    for name, (calls, ms, n) in acc.items():
        out[name] = dict(
            calls=calls,
            calls_per_match=calls / max(matches, 1),
            ms_per_match=sum(ms) / max(matches, 1),
            median_ms=statistics.median(ms),
        )
        if n:
            out[name]["launches_per_call"] = n / calls
    return out


def check_loop_slice(device):
    """Phase 5: the branch-and-bound loop slice on the card vs the CPU.

    A warm-up run of the sequence pays the one-time costs (cuBLAS and
    cuSOLVER handles, allocator growth).  The timed run follows, with the
    kernel launch counts set to 0 just before it and read just after it;
    it times the whole match and the backend step by host clock and adds
    no device sync.  A third run on the card fences every stage of the
    match with syncs for the per-stage breakdown (``loop_stages_fenced``)."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda

    seq = build_loop_sequence()
    run_loop_slice(device, seq)
    torch.cuda.reset_peak_memory_stats(device)
    csm_cuda.LAUNCHES = 0
    hit_images_cuda.LAUNCHES = 0
    unfenced = [s for s in _loop_stages() if not s[3]]
    gpu = run_loop_slice(device, seq, stages=unfenced)
    sweep_launches = csm_cuda.LAUNCHES
    hit_launches = hit_images_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated(device)
    fenced = run_loop_slice(device, seq, stages=_loop_stages())
    cpu = run_loop_slice("cpu", seq)

    n_kf = len(gpu["est"])
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = synthetic.ate_rmse(gpu["est"], gpu["gt"])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth)
    same_kf = len(cpu["est"]) == n_kf
    d = np.abs(gpu["est"] - cpu["est"]) if same_kf else None
    stages = _stage_summary(gpu["stages"], gpu["matches"])
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]), scans=len(seq.scans),
        loop_edges=len(gpu["loops"]), loop_edges_cpu=len(cpu["loops"]),
        ate_m=ate, ate_cpu_m=synthetic.ate_rmse(cpu["est"], cpu["gt"]),
        ate_odom_m=ate_odom,
        bb_matches=gpu["matches"], hit_image_launches=hit_launches,
        csm_sweep_launches=sweep_launches,
        blocks_swept_per_match=gpu["blocks"] / max(gpu["matches"], 1),
        host_fetches_per_bb_match=gpu["fetches"] / max(gpu["matches"], 1),
        bb_match_ms_median=stages["bb match"]["median_ms"],
        backend_step_ms_median=stages["backend step"]["median_ms"],
        wall_s=gpu["wall"], ms_per_keyframe=1e3 * gpu["wall"] / n_kf,
        cpu_wall_s=cpu["wall"],
        peak_mem_bytes=peak,
        max_dxy_m=None if d is None else float(d[:, :2].max()),
        max_dtheta_rad=None if d is None else float(d[:, 2].max()),
    )
    print(f"loop_slice {json.dumps(stats)}", flush=True)
    print(f"loop_stages {json.dumps(stages)}", flush=True)
    print(f"loop_stages_fenced "
          f"{json.dumps(_stage_summary(fenced['stages'], fenced['matches']))}",
          flush=True)
    if fenced["loops"] != gpu["loops"]:
        raise AssertionError("the fenced run closed other loops than the timed run")
    if gpu["matches"] < 1 or len(gpu["loops"]) < 1:
        raise AssertionError(
            f"{gpu['matches']} B&B matches, {len(gpu['loops'])} loop edges")
    if hit_launches != gpu["matches"]:
        raise AssertionError(
            f"{hit_launches} hit-image launches for {gpu['matches']} matches")
    if sweep_launches < 2 * (n_kf - 1):
        raise AssertionError(
            f"{sweep_launches} sweep launches for {n_kf - 1} matched keyframes")
    if not same_kf:
        raise AssertionError(
            f"keyframes differ: cuda {n_kf}, cpu {len(cpu['est'])}")
    if gpu["loops"] != cpu["loops"]:
        raise AssertionError(
            f"loop edges differ: cuda {gpu['loops']}, cpu {cpu['loops']}")
    if stats["max_dxy_m"] > LOOP_TOL_XY or stats["max_dtheta_rad"] > LOOP_TOL_THETA:
        raise AssertionError(
            f"cuda and cpu poses differ beyond tolerance: dxy "
            f"{stats['max_dxy_m']} (tol {LOOP_TOL_XY}), dtheta "
            f"{stats['max_dtheta_rad']} (tol {LOOP_TOL_THETA})")
    if not np.all(np.isfinite(gpu["est"])) or not ate < ate_odom:
        raise AssertionError(f"ATE {ate} does not beat odometry {ate_odom}")
    return stats


def check_correlative_loop_slice(device):
    """Phase 6: the port's default backend,
    ``create_default_backend(sharded=False)``, on config #3's world, on
    the card and on the CPU.  Its serial correlative loop detector runs the
    sweep kernel at crop 448 (coarse: T 208, an 11 x 11 tile at stride 5;
    fine: the top-32 thetas, 10 tiles of 5 x 5).

    One run on the card (the process is warm from the earlier phases), the
    launch count set to 0 just before it and read just after; each loop
    match is timed by host clock (its result fetch synchronizes) with its
    sweep launches counted, and nothing is fenced.  Requires the same
    keyframes and loop edges on both devices, bitwise-equal poses, at
    least one loop edge and ATE below odometry's."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    seq = build_loop_sequence()

    def stages(slam):
        return [(slam.backend.loop_detector.scan_matcher, "optimize_pose",
                 "loop match", False),
                (slam.backend, "run_step", "backend step", False)]

    kw = dict(make_slam=correlative_loop_slam, stages=stages)
    csm_cuda.LAUNCHES = 0
    gpu = run_loop_slice(device, seq, count=lambda: csm_cuda.LAUNCHES, **kw)
    sweep_launches = csm_cuda.LAUNCHES
    cpu = run_loop_slice("cpu", seq, **kw)

    n_kf = len(gpu["est"])
    matches = gpu["stages"].get("loop match", (0, [0.0], 0))
    steps = gpu["stages"].get("backend step", (0, [0.0], 0))
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = synthetic.ate_rmse(gpu["est"], gpu["gt"])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth)
    same_kf = len(cpu["est"]) == n_kf
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]),
        loop_edges=len(gpu["loops"]), loop_edges_cpu=len(cpu["loops"]),
        ate_m=ate, ate_cpu_m=synthetic.ate_rmse(cpu["est"], cpu["gt"]),
        ate_odom_m=ate_odom,
        loop_matches=matches[0], csm_sweep_launches=sweep_launches,
        loop_match_sweep_launches=matches[2],
        loop_match_ms_median=statistics.median(matches[1]),
        backend_steps=steps[0],
        backend_step_sweep_launches=steps[2],
        backend_step_ms_median=statistics.median(steps[1]),
        wall_s=gpu["wall"], cpu_wall_s=cpu["wall"],
        poses_bitwise_equal=same_kf and np.array_equal(gpu["est"], cpu["est"]),
    )
    print(f"correlative_loop_slice {json.dumps(stats)}", flush=True)
    if matches[0] < 1 or len(gpu["loops"]) < 1:
        raise AssertionError(
            f"{matches[0]} loop matches, {len(gpu['loops'])} loop edges")
    if matches[2] < 2 * matches[0]:
        raise AssertionError(
            f"{matches[2]} sweep launches in {matches[0]} loop matches")
    if not same_kf or gpu["loops"] != cpu["loops"]:
        raise AssertionError(
            f"cuda and cpu differ: keyframes {n_kf} / {len(cpu['est'])}, "
            f"loop edges {gpu['loops']} / {cpu['loops']}")
    if not stats["poses_bitwise_equal"]:
        d = np.abs(gpu["est"] - cpu["est"])
        raise AssertionError(
            f"cuda and cpu poses differ: dxy {d[:, :2].max()}, dtheta "
            f"{d[:, 2].max()}")
    if not np.all(np.isfinite(gpu["est"])) or not ate < ate_odom:
        raise AssertionError(f"ATE {ate} does not beat odometry {ate_odom}")
    return stats


def _logged_detects(calls):
    """A ``stages`` hook for :func:`run_loop_slice` that records, per call
    of the batched detector's ``detect``, the batch size, the sweep
    launches and dense re-runs it made and its host ms (the result fetch
    synchronizes, so nothing is fenced); the backend step and the LM (one
    fetch per call) are timed as stages."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    def stages(slam):
        det = slam.backend.loop_detector
        detect = det.detect

        def logged(queries):
            n0, r0 = csm_cuda.LAUNCHES, det.dense_reruns
            t = time.perf_counter()
            out = detect(queries)
            calls.append(dict(n=len(queries),
                              ms=(time.perf_counter() - t) * 1e3,
                              launches=csm_cuda.LAUNCHES - n0,
                              reruns=det.dense_reruns - r0))
            return out

        det.detect = logged
        return [(slam.backend, "run_step", "backend step", False),
                (slam.backend.optimizer, "optimize", "LM", False)]

    return stages


def check_batched_loop_slice(device, serial):
    """Phase 7: the port's default backend, ``create_default_backend()``
    (the batched correlative detector), on config #3's world, on the card
    and on the CPU.

    A warm-up run on the card first; then the timed run, the launch count
    set to 0 just before it and read just after, each ``detect`` and each
    backend step timed by host clock, nothing fenced.  Requires the same
    keyframes and loop edges on both devices, bitwise-equal poses, at least
    one loop edge, ATE below odometry's, and exactly two sweep launches
    per backend step with candidates plus two per dense re-run.  Prints the
    batch sizes and the medians beside phase 6's (``serial``) from this
    process."""
    from collections import Counter

    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda

    seq = build_loop_sequence()
    kw = dict(make_slam=default_loop_slam)
    run_loop_slice(device, seq, stages=_logged_detects([]), **kw)
    calls = []
    csm_cuda.LAUNCHES = hit_images_cuda.LAUNCHES = 0
    gpu = run_loop_slice(device, seq, stages=_logged_detects(calls), **kw)
    sweep_launches = csm_cuda.LAUNCHES
    hit_launches = hit_images_cuda.LAUNCHES
    cpu = run_loop_slice("cpu", seq, **kw)

    n_kf = len(gpu["est"])
    batches = [c for c in calls if c["n"]]
    steps = gpu["stages"].get("backend step", (0, [0.0], 0))
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = synthetic.ate_rmse(gpu["est"], gpu["gt"])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth)
    same_kf = len(cpu["est"]) == n_kf
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]),
        loop_edges=len(gpu["loops"]), loop_edges_cpu=len(cpu["loops"]),
        ate_m=ate, ate_cpu_m=synthetic.ate_rmse(cpu["est"], cpu["gt"]),
        ate_odom_m=ate_odom,
        batch_sizes=dict(sorted(Counter(c["n"] for c in batches).items())),
        candidates=sum(c["n"] for c in batches),
        dense_reruns=sum(c["reruns"] for c in batches),
        csm_sweep_launches=sweep_launches, hit_image_launches=hit_launches,
        detect_sweep_launches=sum(c["launches"] for c in batches),
        host_fetches=gpu["fetches"],
        detect_ms_median=statistics.median(c["ms"] for c in batches)
        if batches else None,
        backend_steps=steps[0],
        backend_step_ms_median=statistics.median(steps[1]),
        lm_ms_median=_median_ms(gpu["stages"], "LM"),
        serial_backend_step_ms_median=serial["backend_step_ms_median"],
        serial_loop_match_ms_median=serial["loop_match_ms_median"],
        wall_s=gpu["wall"], cpu_wall_s=cpu["wall"],
        poses_bitwise_equal=same_kf and np.array_equal(gpu["est"], cpu["est"]),
    )
    print(f"batched_loop_slice {json.dumps(stats)}", flush=True)
    if not batches or len(gpu["loops"]) < 1:
        raise AssertionError(
            f"{len(batches)} batched detects, {len(gpu['loops'])} loop edges")
    wrong = [c for c in batches if c["launches"] != 2 + 2 * c["reruns"]]
    if wrong:
        raise AssertionError(f"detects off two launches per batch: {wrong}")
    if not same_kf or gpu["loops"] != cpu["loops"]:
        raise AssertionError(
            f"cuda and cpu differ: keyframes {n_kf} / {len(cpu['est'])}, "
            f"loop edges {gpu['loops']} / {cpu['loops']}")
    if not stats["poses_bitwise_equal"]:
        d = np.abs(gpu["est"] - cpu["est"])
        raise AssertionError(
            f"cuda and cpu poses differ: dxy {d[:, :2].max()}, dtheta "
            f"{d[:, 2].max()}")
    if not np.all(np.isfinite(gpu["est"])) or not ate < ate_odom:
        raise AssertionError(f"ATE {ate} does not beat odometry {ate_odom}")
    return stats, gpu


def _median_ms(stages, name):
    """Median host ms per call of a timed stage; None if it never ran."""
    return statistics.median(stages[name][1]) if name in stages else None


# The launcher's settings in phase 8: config #3's searcher, and both
# matchers' windows stated rather than left to the loader's defaults.
LAUNCHER_SETTINGS = {
    "ScanMatcherRealTimeCorrelative": {
        "SearchRangeX": 0.25, "SearchRangeY": 0.25, "SearchRangeTheta": 0.5},
    "LoopSearcherNearest": {"TravelDistThreshold": 6.0},
    "LoopDetectorRealTimeCorrelative": {
        "ScanMatcher": {"SearchRangeX": 2.5, "SearchRangeY": 2.5,
                        "SearchRangeTheta": 0.5}},
}


def _png_shape(path):
    """(rows, cols) of an 8-bit grey PNG, its image data decompressed to
    check that it is whole."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if len(zlib.decompress(idat)) != h * (w + 1):
        raise AssertionError(f"{path}: image data of the wrong size")
    return h, w


def check_launcher(device, keyframes):
    """Phase 8: the user's entry point on the card.  Config #3's world is
    written as a Carmen log with the port's writer into a temporary
    directory; ``launcher.main([log, settings, prefix])`` runs with no
    ``--device``, so it must land on CUDA (its sweep launches are counted).
    The saved pose graph is read back with the port's ``load_pose_graph``:
    as many nodes as phase 7's keyframes (the gate reads odometry alone),
    at least one loop edge, and the saved poses' ATE below odometry's;
    the map PNG and the metrics JSON must parse."""
    import tempfile
    from pathlib import Path

    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.io.carmen import write_carmen_log
    from my_lidar_graph_slam_v2_tpu_torch.io.map_saver import load_pose_graph
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda
    from my_lidar_graph_slam_v2_tpu_torch.pipeline import launcher

    seq = build_loop_sequence()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_carmen_log(seq.scans, str(tmp / "config3.log"))
        (tmp / "settings.json").write_text(json.dumps(LAUNCHER_SETTINGS))
        prefix = str(tmp / "config3")
        csm_cuda.LAUNCHES = hit_images_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = launcher.main([str(tmp / "config3.log"),
                            str(tmp / "settings.json"), prefix])
        wall = time.perf_counter() - t0
        launches = csm_cuda.LAUNCHES
        hit_launches = hit_images_cuda.LAUNCHES
        pg = load_pose_graph(f"{prefix}.posegraph.json")
        # The saved graph's time stamps say which scans became keyframes.
        stamps = [n["TimeStamp"] for n in json.loads(
            Path(f"{prefix}.posegraph.json").read_text())["ScanNodes"]]
        rows, cols = _png_shape(f"{prefix}.png")
        meta = json.loads(Path(f"{prefix}.json").read_text())["Map"]
        metrics = json.loads(Path(f"{prefix}.metric.json").read_text())

    times = np.array([s.time_stamp for s in seq.scans])
    gt = seq.ground_truth[[int(np.argmin(np.abs(times - t))) for t in stamps]]
    est = pg.scan_poses()
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = synthetic.ate_rmse(est, gt)
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth)
    stats = dict(
        rc=rc, wall_s=wall, scans=len(seq.scans), csm_sweep_launches=launches,
        hit_image_launches=hit_launches,
        nodes=len(pg.scan_nodes), keyframes_phase7=keyframes,
        loop_edges=sum(e.is_loop for e in pg.edges), ate_m=ate,
        ate_odom_m=ate_odom, map_png=[rows, cols],
        metric_series=len(metrics["ValueSequences"]),
    )
    print(f"launcher {json.dumps(stats)}", flush=True)
    if rc != 0 or launches < 1:
        raise AssertionError(f"launcher exit {rc}, {launches} sweep launches")
    if stats["nodes"] != keyframes or stats["loop_edges"] < 1:
        raise AssertionError(
            f"{stats['nodes']} nodes (phase 7: {keyframes} keyframes), "
            f"{stats['loop_edges']} loop edges")
    if [rows, cols] != [meta["Rows"], meta["Cols"]]:
        raise AssertionError(f"map PNG {rows}x{cols} against metadata {meta}")
    if "Frontend.ProcessTime" not in metrics["ValueSequences"]:
        raise AssertionError("the metrics JSON lacks Frontend.ProcessTime")
    if not np.all(np.isfinite(est)) or not ate < ate_odom:
        raise AssertionError(f"ATE {ate} does not beat odometry {ate_odom}")
    return stats


# The greedy-endpoint cost group of the reference's settings file.
COST_GREEDY_ENDPOINT = {"HitAndMissedDist": 0.075, "OccupancyThreshold": 0.1,
                        "KernelSize": 1, "StandardDeviation": 0.05,
                        "ScalingFactor": 1.0}
# Phase 9: phase 8's windows and searcher, and a loop group whose matcher
# is GridSearch at the reference file's steps, with its GreedyEndpoint cost.
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
# Phase 10: the reference file's HillClimbing group (GreedyEndpoint) as the
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


def settings_slam(settings):
    """A ``make_slam`` for :func:`run_slice` / :func:`run_loop_slice`:
    ``create_slam_from_settings(settings)`` with the inline backend."""
    from my_lidar_graph_slam_v2_tpu_torch.config.settings import (
        create_slam_from_settings,
    )

    def make(device):
        return create_slam_from_settings(settings, device=device,
                                         inline_backend=True)

    return make


def check_grid_search_loop_slice(device):
    """Phase 9: the GridSearch loop detector on config #3's world, on the
    card and on the CPU (plain sweep).  One run on the card (warm from
    the earlier phases), the launch count set to 0 just before it and read
    just after; each grid-search match and each backend step timed by host
    clock (a match's result fetch synchronizes), its sweep launches
    counted apart from the frontend's."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    seq = build_loop_sequence()

    def stages(slam):
        return [(slam.backend.loop_detector.scan_matcher, "optimize_pose",
                 "grid search match", False),
                (slam.backend, "run_step", "backend step", False)]

    kw = dict(make_slam=settings_slam(GRID_SEARCH_SETTINGS), stages=stages)
    csm_cuda.LAUNCHES = 0
    gpu = run_loop_slice(device, seq, count=lambda: csm_cuda.LAUNCHES, **kw)
    sweep_launches = csm_cuda.LAUNCHES
    cpu = run_loop_slice("cpu", seq, **kw)

    n_kf = len(gpu["est"])
    matches = gpu["stages"].get("grid search match", (0, [0.0], 0))
    steps = gpu["stages"].get("backend step", (0, [0.0], 0))
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = synthetic.ate_rmse(gpu["est"], gpu["gt"])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth)
    same_kf = len(cpu["est"]) == n_kf
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]),
        loop_edges=len(gpu["loops"]), loop_edges_cpu=len(cpu["loops"]),
        ate_m=ate, ate_cpu_m=synthetic.ate_rmse(cpu["est"], cpu["gt"]),
        ate_odom_m=ate_odom,
        grid_search_matches=matches[0], csm_sweep_launches=sweep_launches,
        grid_search_sweep_launches=matches[2],
        frontend_sweep_launches=sweep_launches - matches[2],
        host_fetches_per_match=gpu["fetches"] / max(matches[0], 1),
        match_ms_median=statistics.median(matches[1]),
        cpu_match_ms_median=statistics.median(
            cpu["stages"]["grid search match"][1])
        if "grid search match" in cpu["stages"] else None,
        backend_steps=steps[0],
        backend_step_ms_median=statistics.median(steps[1]),
        wall_s=gpu["wall"], cpu_wall_s=cpu["wall"],
        poses_bitwise_equal=same_kf and np.array_equal(gpu["est"], cpu["est"]),
    )
    print(f"grid_search_loop_slice {json.dumps(stats)}", flush=True)
    if matches[0] < 1 or len(gpu["loops"]) < 1:
        raise AssertionError(
            f"{matches[0]} grid-search matches, {len(gpu['loops'])} loop edges")
    if matches[2] != matches[0]:
        raise AssertionError(
            f"{matches[2]} sweep launches in {matches[0]} grid-search matches")
    if not same_kf or gpu["loops"] != cpu["loops"]:
        raise AssertionError(
            f"cuda and cpu differ: keyframes {n_kf} / {len(cpu['est'])}, "
            f"loop edges {gpu['loops']} / {cpu['loops']}")
    if not stats["poses_bitwise_equal"]:
        d = np.abs(gpu["est"] - cpu["est"])
        raise AssertionError(
            f"cuda and cpu poses differ: dxy {d[:, :2].max()}, dtheta "
            f"{d[:, 2].max()}")
    if not np.all(np.isfinite(gpu["est"])) or not ate < ate_odom:
        raise AssertionError(f"ATE {ate} does not beat odometry {ate_odom}")
    return stats


def check_hill_climbing_frontend(device):
    """Phase 10: the HillClimbing frontend (GreedyEndpoint) on phase 4's
    office sequence, on the card (warm from the earlier phases) and on the
    CPU; the launch count set to 0 just before the card's run and read
    just after."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    seq = build_sequence(KEYFRAMES)
    make = settings_slam(HILL_CLIMBING_SETTINGS)
    csm_cuda.LAUNCHES = 0
    gpu = run_slice(device, seq, make_slam=make)
    launches = csm_cuda.LAUNCHES
    cpu = run_slice("cpu", seq, make_slam=make)

    n_kf = len(gpu["est"])
    m = gpu["matcher"]
    odom = np.stack([s.odom_pose for s in seq.scans])
    same_kf = len(cpu["est"]) == n_kf
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]), scans=len(seq.scans),
        wall_s=gpu["wall"], ms_per_keyframe=1e3 * gpu["wall"] / n_kf,
        keyframe_ms_median=statistics.median(gpu["kf_ms"][1:]),
        cpu_ms_per_keyframe=1e3 * cpu["wall"] / max(len(cpu["est"]), 1),
        matches=m.matches, iterations_per_keyframe=m.iterations / m.matches,
        host_fetches_per_keyframe=m.host_fetches / m.matches,
        csm_sweep_launches=launches,
        ate_m=synthetic.ate_rmse(gpu["est"], gpu["gt"]),
        ate_odom_m=synthetic.ate_rmse(odom, seq.ground_truth),
        poses_bitwise_equal=same_kf and np.array_equal(gpu["est"], cpu["est"]),
    )
    print(f"hill_climbing_frontend {json.dumps(stats)}", flush=True)
    if n_kf < 40 or not same_kf:
        raise AssertionError(
            f"keyframes: cuda {n_kf}, cpu {len(cpu['est'])} (need >= 40)")
    if not stats["poses_bitwise_equal"]:
        d = np.abs(gpu["est"] - cpu["est"])
        raise AssertionError(
            f"cuda and cpu poses differ: dxy {d[:, :2].max()}, dtheta "
            f"{d[:, 2].max()}")
    if not np.all(np.isfinite(gpu["est"])) or not stats["ate_m"] < \
            stats["ate_odom_m"]:
        raise AssertionError(
            f"ATE {stats['ate_m']} does not beat odometry "
            f"{stats['ate_odom_m']}")
    if launches != 0:
        raise AssertionError(f"{launches} sweep launches without a sweep")
    return stats


# Phase 11: the multi-device paths' poses against phase 7's, fixed before
# the first chip run.  A one-shard mesh sums the LM in the single-device
# order and two ranks' f64 sums differ from one rank's only in order, far
# below the f32 rounding (bitwise in the CPU tests), so bitwise is
# expected; 1e-4 m / rad would let a last-bit flip after a loop closure
# pass without hiding a wrong sum.
DIST_TOL = 1e-4
# Phase 11c: the two-rank run's ATE within this of phase 7's.
DIST_ATE_TOL = 0.005
# Phase 11c: seconds each worker may take.
WORKER_TIMEOUT_S = 300
LOOP_SEARCHER = dict(travel_dist_threshold=6.0)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


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


def _counted_loop_run(device, seq, make_slam):
    """One run of a loop slice on the card, the kernel counts set to 0
    just before it and read just after, with each ``detect`` logged and
    the backend step and the LM timed (:func:`_logged_detects`)."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda

    calls = []
    csm_cuda.LAUNCHES = hit_images_cuda.LAUNCHES = 0
    run = run_loop_slice(device, seq, stages=_logged_detects(calls),
                         make_slam=make_slam)
    run.update(calls=calls, sweep_launches=csm_cuda.LAUNCHES,
               hit_launches=hit_images_cuda.LAUNCHES)
    return run


def _check_against_phase7(name, gpu, cpu, ref, ref_stats):
    """Phase 11a / 11b: the card's run ``gpu`` against the CPU's ``cpu``
    (bitwise) and phase 7's ``ref`` (``DIST_TOL``); two sweep launches per
    ``detect`` plus two per dense re-run."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic

    batches = [c for c in gpu["calls"] if c["n"]]
    n_kf = len(gpu["est"])
    same = len(ref["est"]) == n_kf
    d = np.abs(gpu["est"] - ref["est"]) if same else None
    steps = gpu["stages"].get("backend step", (0, [0.0], 0))
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]),
        keyframes_phase7=len(ref["est"]),
        loop_edges=len(gpu["loops"]), loop_edges_phase7=len(ref["loops"]),
        ate_m=synthetic.ate_rmse(gpu["est"], gpu["gt"]),
        ate_cpu_m=synthetic.ate_rmse(cpu["est"], cpu["gt"]),
        ate_phase7_m=ref_stats["ate_m"],
        poses_bitwise_equal=(len(cpu["est"]) == n_kf
                             and np.array_equal(gpu["est"], cpu["est"])),
        poses_bitwise_equal_phase7=same and np.array_equal(gpu["est"],
                                                           ref["est"]),
        max_dxy_vs_phase7_m=None if d is None else float(d[:, :2].max()),
        max_dtheta_vs_phase7_rad=None if d is None else float(d[:, 2].max()),
        detects=len(batches), candidates=sum(c["n"] for c in batches),
        dense_reruns=sum(c["reruns"] for c in batches),
        csm_sweep_launches=gpu["sweep_launches"],
        hit_image_launches=gpu["hit_launches"],
        detect_sweep_launches=sum(c["launches"] for c in batches),
        sweep_launches_per_detect=sum(c["launches"] for c in batches)
        / max(len(batches), 1),
        host_fetches=gpu["fetches"],
        detect_ms_median=statistics.median(c["ms"] for c in batches)
        if batches else None,
        backend_steps=steps[0],
        backend_step_ms_median=statistics.median(steps[1]),
        lm_calls=gpu["stages"].get("LM", (0,))[0],
        lm_ms_median=_median_ms(gpu["stages"], "LM"),
        lm_ms_median_phase7=ref_stats["lm_ms_median"],
        wall_s=gpu["wall"], cpu_wall_s=cpu["wall"],
    )
    ranks = getattr(gpu["matcher"], "ranks", None)
    if ranks is not None:
        stats.update(collectives=ranks.calls,
                     collectives_per_backend_step=ranks.calls
                     / max(steps[0], 1))
    print(f"{name} {json.dumps(stats)}", flush=True)
    if not batches:
        raise AssertionError(f"{name}: no batched detect ran")
    wrong = [c for c in batches if c["launches"] != 2 + 2 * c["reruns"]]
    if wrong:
        raise AssertionError(f"{name}: detects off two launches: {wrong}")
    if not same or len(cpu["est"]) != n_kf:
        raise AssertionError(
            f"{name}: keyframes {n_kf}, cpu {len(cpu['est'])}, phase 7 "
            f"{len(ref['est'])}")
    if not gpu["loops"] == cpu["loops"] == ref["loops"]:
        raise AssertionError(
            f"{name}: loop edges {gpu['loops']}, cpu {cpu['loops']}, phase 7 "
            f"{ref['loops']}")
    if not stats["poses_bitwise_equal"]:
        dc = np.abs(gpu["est"] - cpu["est"])
        raise AssertionError(
            f"{name}: cuda and cpu poses differ: dxy {dc[:, :2].max()}, "
            f"dtheta {dc[:, 2].max()}")
    if d.max() > DIST_TOL or not np.all(np.isfinite(gpu["est"])):
        raise AssertionError(
            f"{name}: poses differ from phase 7's by {d.max()} "
            f"(tol {DIST_TOL})")
    return stats


def check_distributed_loop_slice(device, ref, ref_stats):
    """Phase 11a: ``create_distributed_backend`` on the one-device mesh
    ``(cuda:0,)`` and on ``("cpu",)``, against phase 7's run."""
    seq = build_loop_sequence()
    gpu = _counted_loop_run(device, seq, distributed_loop_slam)
    cpu = run_loop_slice("cpu", seq, make_slam=distributed_loop_slam)
    return (_check_against_phase7("distributed_loop_slice", gpu, cpu, ref,
                                  ref_stats), gpu)


def check_multihost_loop_slice(device, ref, ref_stats):
    """Phase 11b: ``create_multihost_backend`` in this process, on the card
    in an NCCL group of one rank (the only NCCL group one card can hold)
    and on the CPU in a gloo group of one rank, each group destroyed after
    its run, against phase 7's run."""
    import torch.distributed as dist

    from my_lidar_graph_slam_v2_tpu_torch.parallel import multihost

    seq = build_loop_sequence()
    runs = {}
    for backend, dev in (("nccl", device), ("gloo", torch.device("cpu"))):
        multihost.init_multihost(f"tcp://localhost:{_free_port()}", 1, 0,
                                 backend=backend)
        try:
            runs[backend] = (
                _counted_loop_run(dev, seq, multihost_loop_slam)
                if dev.type == "cuda"
                else run_loop_slice(dev, seq, make_slam=multihost_loop_slam))
        finally:
            dist.destroy_process_group()
    return _check_against_phase7("multihost_loop_slice", runs["nccl"],
                                 runs["gloo"], ref, ref_stats)


def check_two_ranks(device, ref, ref_stats, one_process_slam):
    """Phase 11c: two ``parallel/worker.py`` processes (gloo, both on
    ``device``, config #3's world at the factory defaults), started with
    ``subprocess`` and both killed on failure; against phase 7's run and
    the owner-sharded global map of ``one_process_slam`` (phase 11a's run)
    built in this one process."""
    import os
    from pathlib import Path

    from my_lidar_graph_slam_v2_tpu_torch.parallel.multihost import (
        construct_global_map_sharded,
    )
    from my_lidar_graph_slam_v2_tpu_torch.parallel.worker import (
        check_owner_sharded,
    )

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "my_lidar_graph_slam_v2_tpu_torch.parallel.worker",
         "--init-method", f"tcp://localhost:{port}", "--world-size", "2",
         "--rank", str(rank), "--backend", "gloo", "--device", str(device),
         "--world", "config3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env=env) for rank in (0, 1)]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(
                    f"a worker exited {p.returncode}:\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    r0, r1 = outs
    _, gmap = construct_global_map_sharded(one_process_slam)
    one_cells = int(gmap.observed.sum())
    t0_, t1_ = (np.array(r["trajectory"]) for r in (r0, r1))
    loops = [[tuple(e) for e in r["loop_edges"]] for r in (r0, r1)]
    keep = lambda r: {k: v for k, v in r.items()  # noqa: E731
                      if k not in ("trajectory", "loop_edges")}
    stats = dict(
        ranks=[keep(r) for r in (r0, r1)], command_wall_s=wall,
        lockstep_bitwise=t0_.shape == t1_.shape and np.array_equal(t0_, t1_),
        poses_bitwise_equal_phase7=t0_.shape == ref["est"].shape
        and np.array_equal(t0_, ref["est"]),
        keyframes_phase7=len(ref["est"]), loop_edges_phase7=len(ref["loops"]),
        ate_phase7_m=ref_stats["ate_m"],
        one_process_global_map_observed_cells=one_cells,
    )
    print(f"two_rank_loop_slice {json.dumps(stats)}", flush=True)
    if not stats["lockstep_bitwise"] or loops[0] != loops[1]:
        raise AssertionError("the two ranks' trajectories differ")
    if r0["keyframes"] != len(ref["est"]) or loops[0] != ref["loops"]:
        raise AssertionError(
            f"keyframes {r0['keyframes']}, loop edges {loops[0]}; phase 7: "
            f"{len(ref['est'])}, {ref['loops']}")
    if abs(r0["ate"] - ref_stats["ate_m"]) > DIST_ATE_TOL:
        raise AssertionError(
            f"ATE {r0['ate']} against phase 7's {ref_stats['ate_m']}")
    for r in (r0, r1):
        foreign = [m for m in r["rasterized_map_ids"]
                   if m % 2 != r["process_id"]]
        if foreign:
            raise AssertionError(
                f"rank {r['process_id']} rasterized non-owned maps {foreign}")
    if not r0["detect_sweep_launches"] + r1["detect_sweep_launches"]:
        raise AssertionError("no rank launched a loop sweep")
    check_owner_sharded(r0, r1)
    if not (r0["global_map_observed_cells"] == r1["global_map_observed_cells"]
            == one_cells > 0):
        raise AssertionError(
            f"global map observed cells {r0['global_map_observed_cells']}, "
            f"{r1['global_map_observed_cells']}; one process {one_cells}")
    return stats


# Phase 12's bars, fixed before its first run: synth7 and synth11 as the
# CPU test (tests/test_torch_h2h.py) holds them; synth3 at the binary's 997
# nodes and at least its 366 loop edges, ATE at or below the binary's
# (0.1116 m) and at most the JAX artifact's (0.02485 m) plus the slack.
H2H_SLACK = 0.005
H2H_SEEDS = (7, 11, 3)


def check_head_to_head():
    """Phase 12: the committed logs ``h2h/synth{7,11,3}.clf`` through
    ``scripts/head_to_head.py:head_to_head`` on the card (the port's
    launcher in a subprocess with ``--device cuda`` and the binary's
    settings, scored against ground truth beside the reference binary's
    recorded run and the JAX package's artifact, and the optimizer
    cross-check); prints each log's wall time, the launcher's kernel
    launches and its peak device memory."""
    import tempfile

    from my_lidar_graph_slam_v2_tpu_torch.scripts import head_to_head as h2h

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in H2H_SEEDS:
            r = h2h.head_to_head(seed, tmp, device="cuda")
            ours, ref, jax_art = r["ours"], r["reference"], r["jax_artifact"]
            row = dict(seed=seed, **{k: v for k, v in ours.items()
                                     if k != "device_report"},
                       **ours["device_report"], reference=ref,
                       jax_artifact=jax_art,
                       optimizer_cross_check=r["optimizer_cross_check"])
            print(f"head_to_head {json.dumps(row)}", flush=True)
            loops_ok = (ours["loop_edges"] >= ref["loop_edges"] if seed == 3
                        else ours["loop_edges"] == ref["loop_edges"])
            if not (ours["nodes"] == ref["nodes"] == jax_art["nodes"]
                    and loops_ok and row["csm_sweep_launches"] > 0
                    and ours["ate_m"] <= ref["ate_m"]
                    and ours["ate_m"] <= jax_art["ate_m"] + H2H_SLACK):
                raise AssertionError(
                    f"synth{seed}: {ours} against the binary's {ref} and "
                    f"the JAX artifact's {jax_art}")
            rows.append(row)
    return rows


def check_scripts(device):
    """Phase 13: the port's measurement scripts on the card.

    (a) ``bench_csm.measure``: the C++ baseline's live rate in its
    subprocess, the batched core's matches/s at batch 8 and 16 and the
    stage ms, with the batch-8 outputs equal to the CPU's (plain sweep)
    bit for bit.  (b) ``eval_ate``'s four configurations: the keyframes of
    ``results_ate.json``, ATE below odometry's, at least one loop edge for
    #2-#4 (printed beside the file's), and for #3 at least one hit-image
    launch per branch-and-bound match.  (c) ``bench_e2e.run`` at 200
    keyframes with the threaded backend: ATE below odometry's."""
    from pathlib import Path

    from my_lidar_graph_slam_v2_tpu_torch.matching import branch_bound
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda
    from my_lidar_graph_slam_v2_tpu_torch.scripts import (
        bench_csm,
        bench_e2e,
        eval_ate,
        eval_bb_pyramid,
        eval_scaling,
        eval_scaling_pipeline,
    )

    out = {}
    cases = bench_csm.build_workload()
    csm_cuda.LAUNCHES = 0
    bench = bench_csm.measure(device, cases)
    bench["csm_sweep_launches"] = csm_cuda.LAUNCHES
    print(f"bench_csm {json.dumps(bench)}", flush=True)
    _, _, gpu = bench_csm.bench_device(cases, iters=1, device=device,
                                       with_stages=False)
    _, _, cpu = bench_csm.bench_device(cases, iters=1, device="cpu",
                                       with_stages=False)
    if not all(torch.equal(g.cpu(), c) for g, c in zip(gpu, cpu)):
        raise AssertionError("bench_csm: the card's batch differs from the "
                             "CPU's")
    if not (bench["value"] > 0 and bench["value_batch16"] > 0
            and bench["csm_sweep_launches"] > 0):
        raise AssertionError(f"bench_csm: {bench}")
    out["bench_csm"] = bench

    recorded = {r["config"]: r for r in json.loads(
        (Path(__file__).resolve().parent / "results_ate.json").read_text())}
    out["eval_ate"] = []
    for name, kw in eval_ate.configs():
        csm_cuda.LAUNCHES = hit_images_cuda.LAUNCHES = 0
        bb = [(branch_bound.ScanMatcherBranchBound, "optimize_pose",
               "bb match", False)]
        with StageTimer(device, bb) as timer:
            r = eval_ate.run_config(name, device=device, **kw)
        r.update(csm_sweep_launches=csm_cuda.LAUNCHES,
                 hit_image_launches=hit_images_cuda.LAUNCHES,
                 bb_matches=timer.acc.get("bb match", (0,))[0],
                 recorded_keyframes=recorded[name]["keyframes"],
                 recorded_loop_edges=recorded[name]["loop_edges"])
        print(f"eval_ate {json.dumps(r)}", flush=True)
        loops = kw["backend_kind"] is not None
        if (r["keyframes"] != r["recorded_keyframes"]
                or not r["ate_m"] < r["ate_odometry_m"]
                or (loops and r["loop_edges"] < 1)):
            raise AssertionError(f"eval_ate {name}: {r}")
        if kw["backend_kind"] == "branchbound" and not (
                r["bb_matches"] >= 1
                and r["hit_image_launches"] >= r["bb_matches"]):
            raise AssertionError(f"eval_ate {name}: {r['hit_image_launches']} "
                                 f"hit-image launches in {r['bb_matches']} "
                                 "branch-and-bound matches")
        out["eval_ate"].append(r)

    csm_cuda.LAUNCHES = 0
    e2e = bench_e2e.run(200, threaded=True, progress=False, device=device)
    e2e["csm_sweep_launches"] = csm_cuda.LAUNCHES
    print(f"bench_e2e {json.dumps({k: v for k, v in e2e.items() if k != 'stages'})}",
          flush=True)
    if not (e2e["keyframes"] > 100 and e2e["ate_rmse_m"] < e2e["ate_odometry_m"]):
        raise AssertionError(f"bench_e2e: {e2e}")
    out["bench_e2e"] = e2e

    csm_cuda.LAUNCHES = csm_cuda.F32_LAUNCHES = hit_images_cuda.LAUNCHES = 0
    bb = eval_bb_pyramid.run(device)
    bb.update(csm_sweep_launches=csm_cuda.LAUNCHES,
              hit_image_launches=hit_images_cuda.LAUNCHES)
    print(f"eval_bb_pyramid {json.dumps(bb)}", flush=True)
    for name in ("noise", "peaked"):
        m = bb[f"{name}_map"]
        if not (m["bb_found"] and m["dense_found"]
                and m["bb_score"] == m["dense_gated_best_score"]):
            raise AssertionError(f"eval_bb_pyramid, {name} map: {m}")
    if not (bb["peaked_map"]["bb_blocks_swept"]
            < bb["noise_map"]["bb_blocks_swept"] and bb["hit_image_launches"]
            and bb["csm_sweep_launches"]):
        raise AssertionError(f"eval_bb_pyramid: {bb}")
    out["eval_bb_pyramid"] = bb

    csm_cuda.LAUNCHES = 0
    scaling = eval_scaling.run(device, [1])
    scaling["csm_sweep_launches"] = csm_cuda.LAUNCHES
    print(f"eval_scaling {json.dumps(scaling)}", flush=True)
    r = scaling["results"][0]
    if not (r["devices"] == 1 and r["loop_candidates_per_s"] > 0
            and r["schur_lm_iterations"] >= 1
            and scaling["csm_sweep_launches"] > 0):
        raise AssertionError(f"eval_scaling: {scaling}")
    out["eval_scaling"] = scaling

    pipe = eval_scaling_pipeline.run(device)
    print(f"eval_scaling_pipeline {json.dumps(pipe)}", flush=True)
    if not (pipe["ate_identical"] and pipe["trajectory_identical"]
            and pipe["ranks_bitwise_equal"]
            and pipe["p1"]["keyframes"] == pipe["p2"]["keyframes"]
            and min(pipe["p2"]["csm_sweep_launches"]) > 0):
        raise AssertionError(f"eval_scaling_pipeline: {pipe}")
    out["eval_scaling_pipeline"] = pipe
    return out


# Phase 14: the f32-map matches against the u8 matches of the same query,
# fixed before the first run: the same found flag, and where both found a
# pose, within one cell (0.05 m) and 0.02 rad (a few theta steps at the
# loop window): the u8 map moves each probability by at most 1/510, which
# may move a near-tie argmax by a cell.  The queries matched on the CPU as
# well, poses bitwise equal.
F32_U8_TOL_XY = 0.05
F32_U8_TOL_THETA = 0.02
F32_CPU_QUERIES = 4


def _f32_matchers(device, mcfg):
    """The phase-14 matchers on ``device``: the batched loop detector's
    correlative config at "highest" and "split" and with the gather sweep
    backend (the whole map as the window), the grid search at the
    reference's steps (phase 9's) and branch-and-bound at the
    ``BranchBoundConfig`` defaults (phase 5's)."""
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


def check_f32_maps(device, phase7):
    """Phase 14: f32 maps at full width.  Config #3's world through the
    default backend (phase 7's system) with finished maps kept as f32
    log-odds, so each loop query of phase 7 (captured with its map-local
    pose as the detector got it) can be matched against its local map as
    an f32 probability raster (``rasterize.prob_map``, 1024 x 1024 at
    5 cm) and as the map cache's u8 raster.  Matchers: the batched loop
    detector's correlative config (2.5 m x 2.5 m x 0.5 rad, crop 448,
    T 208) at "highest" and "split" and with the gather backend, the grid
    search at phase 9's steps and branch-and-bound at phase 5's config,
    each at the detector's
    thresholds.  Per match: host ms (its fetch synchronizes), f32 and u8
    sweep launches, f32 pack launches and hit-image launches;
    :data:`F32_CPU_QUERIES` queries (those the u8 match found a pose for
    first) also on the CPU."""
    from my_lidar_graph_slam_v2_tpu_torch.core import pose as P
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import scan_to_arrays
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
        MapRaster,
        ScanMatchingQuery,
    )
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )
    from my_lidar_graph_slam_v2_tpu_torch.ops import (
        csm_cuda,
        hit_images_cuda,
        rasterize,
    )

    seq = build_loop_sequence()
    queries = []

    def capture(slam):
        det = slam.backend.loop_detector
        detect = det.detect

        def captured(qs):
            for q in qs:
                queries.append(dict(
                    local_map=q["local_map"], scan=q["query_node"].scan_data,
                    pose=P.inverse_compound(q["local_map_node"].global_pose,
                                            q["query_node"].global_pose)))
            return detect(qs)

        det.detect = captured
        return []

    run = run_loop_slice(device, seq, stages=capture,
                         make_slam=default_loop_slam,
                         builder_overrides=dict(compact_finished_maps=False))
    if run["loops"] != phase7["loops"] or len(run["est"]) != len(
            phase7["est"]):
        raise AssertionError("the uncompacted run differs from phase 7's")
    det = run["slam"].backend.loop_detector
    thr = (float(np.float32(det.cfg.score_threshold)),
           float(np.float32(det.cfg.known_rate_threshold)))
    rasters = {}

    def rasters_of(lm):
        if lm.local_map_id not in rasters:
            rasters[lm.local_map_id] = (
                MapRaster(rasterize.prob_map(lm.logodds, lm.observed),
                          lm.observed, det.resolution, lm.offset_xy),
                det.map_cache.raster(lm))
        return rasters[lm.local_map_id]

    gpu_m = _f32_matchers(device, det.mcfg)
    u8_ref = dict(correlative=gpu_m["correlative_split"],
                  grid_search=gpu_m["grid_search"],
                  branch_bound=gpu_m["branch_bound"])
    counters = MetricManager.instance()

    def reruns(m):
        name = getattr(m, "name", None)
        return counters.counter(f"{name}.DenseFallbacks").value if name else 0

    rows = {name: [] for name in gpu_m}
    cpu_m = _f32_matchers(torch.device("cpu"), det.mcfg)
    cpu_equal = 0
    # The card's half: every query, the u8 matches first.
    for q in queries:
        f32_raster, u8_raster = rasters_of(q["local_map"])
        arrays = scan_to_arrays(q["scan"], det.cfg.beam_capacity, device)
        u8 = {k: m.optimize_pose(ScanMatchingQuery(u8_raster, arrays,
                                                   q["pose"]), *thr)
              for k, m in u8_ref.items()}
        for name, m in gpu_m.items():
            n0 = (csm_cuda.F32_LAUNCHES, csm_cuda.LAUNCHES,
                  hit_images_cuda.LAUNCHES, reruns(m),
                  csm_cuda.F32_PACK_LAUNCHES)
            t = time.perf_counter()
            r = m.optimize_pose(ScanMatchingQuery(f32_raster, arrays,
                                                  q["pose"]), *thr)
            ms = (time.perf_counter() - t) * 1e3
            ref = u8[name.split("_")[0] if name.startswith("corr")
                     else name]
            d = np.abs(np.asarray(r.estimated_pose)
                       - np.asarray(ref.estimated_pose))
            rows[name].append(dict(
                ms=ms, f32=csm_cuda.F32_LAUNCHES - n0[0],
                pack=csm_cuda.F32_PACK_LAUNCHES - n0[4],
                u8=csm_cuda.LAUNCHES - n0[1],
                hits=hit_images_cuda.LAUNCHES - n0[2], reruns=reruns(m) - n0[3],
                found=r.pose_found, found_u8=ref.pose_found,
                dxy=float(d[:2].max()) if r.pose_found and ref.pose_found
                else 0.0,
                dtheta=float(d[2]) if r.pose_found and ref.pose_found
                else 0.0,
                pose=np.asarray(r.estimated_pose)))
    # The CPU half: the first queries the u8 loop match found a pose for,
    # then the others in order.
    found = [i for i in range(len(queries))
             if rows["correlative_split"][i]["found_u8"]]
    cpu_queries = (found + [i for i in range(len(queries))
                            if i not in found])[:F32_CPU_QUERIES]
    for i in cpu_queries:
        q = queries[i]
        cpu_arrays = scan_to_arrays(q["scan"], det.cfg.beam_capacity, "cpu")
        cpu_raster = _raster_on(rasters_of(q["local_map"])[0], "cpu")
        for name, m in cpu_m.items():
            r = m.optimize_pose(ScanMatchingQuery(cpu_raster, cpu_arrays,
                                                  q["pose"]), *thr)
            g = rows[name][i]
            if r.pose_found != g["found"] or not np.array_equal(
                    np.asarray(r.estimated_pose), g["pose"]):
                raise AssertionError(
                    f"f32 maps, query {i}, {name}: cuda {g['pose']} found "
                    f"{g['found']}, cpu {r.estimated_pose} found "
                    f"{r.pose_found}")
        cpu_equal += 1
    small = check_small_cell_rasters(
        [queries[i] for i in cpu_queries], rasters_of, gpu_m, cpu_m, det,
        thr, device)

    stats = dict(queries=len(queries), keyframes=len(run["est"]),
                 loop_edges=len(run["loops"]),
                 queries_bitwise_equal_on_cpu=cpu_equal,
                 cpu_queries=cpu_queries,
                 cpu_queries_found=sum(i in found for i in cpu_queries),
                 small_cells=small, matchers={})
    for name, rs in rows.items():
        n = len(rs)
        stats["matchers"][name] = dict(
            matches=n, ms_median=statistics.median(r["ms"] for r in rs),
            f32_launches_per_match=sum(r["f32"] for r in rs) / n,
            u8_launches_per_match=sum(r["u8"] for r in rs) / n,
            hit_image_launches_per_match=sum(r["hits"] for r in rs) / n,
            dense_reruns=sum(r["reruns"] for r in rs),
            found=sum(r["found"] for r in rs),
            found_u8=sum(r["found_u8"] for r in rs),
            max_dxy_vs_u8_m=max(r["dxy"] for r in rs),
            max_dtheta_vs_u8_rad=max(r["dtheta"] for r in rs))
    stats["f32_sweep_launches"] = sum(r["f32"] for rs in rows.values()
                                      for r in rs)
    stats["f32_pack_launches"] = sum(r["pack"] for rs in rows.values()
                                     for r in rs)
    print(f"f32_maps {json.dumps(stats)}", flush=True)
    if len(queries) < F32_CPU_QUERIES or cpu_equal < F32_CPU_QUERIES:
        raise AssertionError(f"{len(queries)} queries, {cpu_equal} on the CPU")
    for name, rs in rows.items():
        want_f32 = {"grid_search": 1, "branch_bound": 0}.get(name, 2)
        for r in rs:
            if (r["f32"] != want_f32 * (1 + r["reruns"]) or r["u8"]
                    or r["pack"] != r["f32"]
                    or r["hits"] != (name == "branch_bound")):
                raise AssertionError(f"f32 maps, {name}: launches {r}")
            if r["found"] != r["found_u8"]:
                raise AssertionError(f"f32 maps, {name}: found {r['found']}, "
                                     f"u8 {r['found_u8']}")
            if r["dxy"] > F32_U8_TOL_XY or r["dtheta"] > F32_U8_TOL_THETA:
                raise AssertionError(f"f32 maps, {name}: pose off the u8 "
                                     f"match's by {r['dxy']}, {r['dtheta']}")
    return stats


def check_small_cell_rasters(queries, rasters_of, gpu_m, cpu_m, det, thr,
                             device):
    """Phase 14, cells below 2^-18 (ROADMAP 3.15): each query's f32 raster
    with its free cells (observed, probability below 0.5) set to 1e-7,
    matched by every phase-14 matcher on the card and on the CPU: found
    flags and poses bitwise equal.  Returns the launches and found counts
    per matcher."""
    from my_lidar_graph_slam_v2_tpu_torch.loop.detector import scan_to_arrays
    from my_lidar_graph_slam_v2_tpu_torch.matching.types import (
        MapRaster,
        ScanMatchingQuery,
    )
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, hit_images_cuda

    rows = {name: dict(found=0, f32=0, pack=0, hits=0) for name in gpu_m}
    free_cells = []
    for q in queries:
        r = rasters_of(q["local_map"])[0]
        free = r.observed & (r.prob < 0.5)
        free_cells.append(int(free.sum()))
        small = MapRaster(torch.where(free, 1e-7, r.prob), r.observed,
                          r.resolution, r.offset_xy)
        cpu_small = _raster_on(small, "cpu")
        arrays = scan_to_arrays(q["scan"], det.cfg.beam_capacity, device)
        cpu_arrays = scan_to_arrays(q["scan"], det.cfg.beam_capacity, "cpu")
        for name, m in gpu_m.items():
            n0 = (csm_cuda.F32_LAUNCHES, csm_cuda.F32_PACK_LAUNCHES,
                  hit_images_cuda.LAUNCHES)
            g = m.optimize_pose(ScanMatchingQuery(small, arrays, q["pose"]),
                                *thr)
            row = rows[name]
            row["f32"] += csm_cuda.F32_LAUNCHES - n0[0]
            row["pack"] += csm_cuda.F32_PACK_LAUNCHES - n0[1]
            row["hits"] += hit_images_cuda.LAUNCHES - n0[2]
            row["found"] += bool(g.pose_found)
            c = cpu_m[name].optimize_pose(
                ScanMatchingQuery(cpu_small, cpu_arrays, q["pose"]), *thr)
            if c.pose_found != g.pose_found or not np.array_equal(
                    np.asarray(c.estimated_pose),
                    np.asarray(g.estimated_pose)):
                raise AssertionError(
                    f"f32 maps below 2^-18, {name}: cuda {g.estimated_pose} "
                    f"found {g.pose_found}, cpu {c.estimated_pose} found "
                    f"{c.pose_found}")
    if not all(free_cells):
        raise AssertionError(f"f32 maps below 2^-18: free cells {free_cells}")
    return dict(queries=len(queries), bitwise_equal_on_cpu=len(queries),
                free_cells_at_1e_7=free_cells, matchers=rows,
                f32_sweep_launches=sum(r["f32"] for r in rows.values()))


def gather_loop_slam(device, **factory_kw):
    """Phase 6's system with the loop matcher's ``sweep_backend="gather"``:
    the serial correlative detector at the factory's window, its fused
    matcher rebuilt at the same configs but for the backend, each sweep
    over the whole (pooled) map with no crop."""
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


# Phases 15 and 16: the ATE within this of the phase each one varies.
BACKEND_ATE_TOL = 0.005


def check_gather_loop_slice(device, serial):
    """Phase 15: phase 6's slice with the gather sweep backend, on the card
    (the counts set to 0 just before and read just after) and on the CPU:
    the same keyframes as phase 6 (``serial``), at least one loop edge, the
    same keyframes, loop edges and bitwise poses on both devices, ATE below
    odometry's and within 0.005 m of phase 6's, two sweep launches per loop
    match or more (dense re-runs); prints loop edges and ms per match
    beside phase 6's."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    seq = build_loop_sequence()

    def stages(slam):
        return [(slam.backend.loop_detector.scan_matcher, "optimize_pose",
                 "loop match", False),
                (slam.backend, "run_step", "backend step", False)]

    kw = dict(make_slam=gather_loop_slam, stages=stages)
    csm_cuda.LAUNCHES = csm_cuda.F32_LAUNCHES = 0
    gpu = run_loop_slice(device, seq, count=lambda: csm_cuda.LAUNCHES, **kw)
    sweep_launches, f32_launches = csm_cuda.LAUNCHES, csm_cuda.F32_LAUNCHES
    cpu = run_loop_slice("cpu", seq, **kw)

    n_kf = len(gpu["est"])
    matches = gpu["stages"].get("loop match", (0, [0.0], 0))
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = synthetic.ate_rmse(gpu["est"], gpu["gt"])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth)
    same_kf = len(cpu["est"]) == n_kf
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]),
        keyframes_phase6=serial["keyframes"],
        loop_edges=len(gpu["loops"]), loop_edges_cpu=len(cpu["loops"]),
        loop_edges_phase6=serial["loop_edges"],
        ate_m=ate, ate_cpu_m=synthetic.ate_rmse(cpu["est"], cpu["gt"]),
        ate_phase6_m=serial["ate_m"], ate_odom_m=ate_odom,
        loop_matches=matches[0], csm_sweep_launches=sweep_launches,
        f32_sweep_launches=f32_launches,
        loop_match_sweep_launches=matches[2],
        loop_match_ms_median=statistics.median(matches[1]),
        loop_match_ms_median_phase6=serial["loop_match_ms_median"],
        wall_s=gpu["wall"], cpu_wall_s=cpu["wall"],
        poses_bitwise_equal=same_kf and np.array_equal(gpu["est"], cpu["est"]),
    )
    print(f"gather_loop_slice {json.dumps(stats)}", flush=True)
    if n_kf != serial["keyframes"] or matches[0] < 1 or not gpu["loops"]:
        raise AssertionError(
            f"{n_kf} keyframes (phase 6: {serial['keyframes']}), "
            f"{matches[0]} loop matches, {len(gpu['loops'])} loop edges")
    if matches[2] < 2 * matches[0]:
        raise AssertionError(
            f"{matches[2]} sweep launches in {matches[0]} loop matches")
    if not same_kf or gpu["loops"] != cpu["loops"]:
        raise AssertionError(
            f"cuda and cpu differ: keyframes {n_kf} / {len(cpu['est'])}, "
            f"loop edges {gpu['loops']} / {cpu['loops']}")
    if not stats["poses_bitwise_equal"]:
        d = np.abs(gpu["est"] - cpu["est"])
        raise AssertionError(
            f"cuda and cpu poses differ: dxy {d[:, :2].max()}, dtheta "
            f"{d[:, 2].max()}")
    if not (np.all(np.isfinite(gpu["est"])) and ate < ate_odom
            and abs(ate - serial["ate_m"]) <= BACKEND_ATE_TOL):
        raise AssertionError(f"ATE {ate}: odometry {ate_odom}, phase 6 "
                             f"{serial['ate_m']}")
    return stats


def check_scatter_slice(device, frontend):
    """Phase 16: phase 4's frontend slice (48 keyframes) with
    ``rasterize_backend="scatter"`` on the card (the counts set to 0 just
    before and read just after) and on the CPU: phase 4's keyframes,
    bitwise-equal poses on both devices, ATE below odometry's and within
    0.005 m of phase 4's (``frontend``); prints ms per keyframe beside
    phase 4's."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    seq = build_sequence(KEYFRAMES)
    kw = dict(builder_overrides=dict(rasterize_backend="scatter"))
    csm_cuda.LAUNCHES = 0
    gpu = run_slice(device, seq, **kw)
    launches = csm_cuda.LAUNCHES
    cpu = run_slice("cpu", seq, **kw)
    n_kf = len(gpu["est"])
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate = synthetic.ate_rmse(gpu["est"], gpu["gt"])
    ate_odom = synthetic.ate_rmse(odom, seq.ground_truth)
    same_kf = len(cpu["est"]) == n_kf
    stats = dict(
        keyframes=n_kf, keyframes_cpu=len(cpu["est"]),
        keyframes_phase4=frontend["keyframes"], wall_s=gpu["wall"],
        ms_per_keyframe=1e3 * gpu["wall"] / n_kf,
        ms_per_keyframe_phase4=frontend["ms_per_keyframe"],
        keyframe_ms_median=statistics.median(gpu["kf_ms"][1:]),
        keyframe_ms_median_phase4=frontend["keyframe_ms_median"],
        cpu_ms_per_keyframe=1e3 * cpu["wall"] / max(len(cpu["est"]), 1),
        launches=launches, ate_m=ate, ate_phase4_m=frontend["ate_m"],
        ate_odom_m=ate_odom,
        poses_bitwise_equal=same_kf and np.array_equal(gpu["est"], cpu["est"]),
    )
    print(f"scatter_slice {json.dumps(stats)}", flush=True)
    if n_kf != frontend["keyframes"] or not same_kf:
        raise AssertionError(f"keyframes: cuda {n_kf}, cpu {len(cpu['est'])}"
                             f", phase 4 {frontend['keyframes']}")
    if not stats["poses_bitwise_equal"]:
        d = np.abs(gpu["est"] - cpu["est"])
        raise AssertionError(
            f"cuda and cpu poses differ: dxy {d[:, :2].max()}, dtheta "
            f"{d[:, 2].max()}")
    if not (np.all(np.isfinite(gpu["est"])) and ate < ate_odom
            and abs(ate - frontend["ate_m"]) <= BACKEND_ATE_TOL):
        raise AssertionError(f"ATE {ate}: odometry {ate_odom}, phase 4 "
                             f"{frontend['ate_m']}")
    if launches < 2 * (n_kf - 1):
        raise AssertionError(f"{launches} sweep launches for {n_kf} "
                             "keyframes")
    return stats


# Phase 17a: the threaded run's ATE bound (tests/test_async_pipeline.py).
ASYNC_ATE_MAX = 0.12


def async_sequence():
    """The world of ``tests/test_async_pipeline.py``: a 10 m office, 1.25
    laps at 0.3 m, 121 beams, odometry noise (0.05, 0.02), seed 22."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic

    return synthetic.generate(
        synthetic.World.office(seed=21, size=10.0),
        synthetic.loop_trajectory(size=10.0, laps=1.25, step=0.3),
        n_beams=121, max_range=10.0, range_noise=0.01,
        odom_noise=(0.05, 0.02), seed=22)


def run_async(device, seq, inline):
    """The async test's system (384^2 maps, 256 beams, 192 samples, 48
    thetas, crop 256, the default batched backend, a local map every
    1.5 m) over ``seq``, inline or with the backend on its worker
    thread."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )

    backend = create_default_backend(
        device=device, usable_range_max=10.0, n_theta_max=48, crop=256,
        beam_capacity=256, inline=inline,
        searcher_overrides=dict(travel_dist_threshold=10.0,
                                node_dist_threshold=5.0))
    slam = create_default_slam(
        device=device, map_rows=384, map_cols=384, beam_capacity=256,
        samples_per_beam=192, usable_range_max=10.0, n_theta_max=48,
        crop=256, backend=backend,
        builder_overrides=dict(travel_dist_threshold=1.5))
    slam.start_backend()
    gt = []
    t0 = time.perf_counter()
    for scan, g in zip(seq.scans, seq.ground_truth):
        if slam.process_scan(scan, scan.odom_pose):
            gt.append(g)
    slam.stop_backend()
    wall = time.perf_counter() - t0
    est = slam.get_trajectory()
    return dict(slam=slam, est=est, wall_s=wall,
                ate_m=synthetic.ate_rmse(est, np.asarray(gt)),
                loops=sum(1 for e in slam.pose_graph.edges if e.is_loop))


def check_async_pipeline(device):
    """Phase 17a: the async test's world inline on the card and on the CPU
    (the same keyframes and loop edges, poses bitwise equal), then with the
    backend on its worker thread on the card: at least one worker step and
    ATE below 0.12 m.  Prints the threaded run's waits: ``opt_wait_count``,
    ``lag_wait_count`` and ``Frontend.BackendLagWaitTime``."""
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda

    seq = async_sequence()
    csm_cuda.LAUNCHES = 0
    inline = run_async(device, seq, True)
    inline_launches = csm_cuda.LAUNCHES
    cpu = run_async("cpu", seq, True)
    lag = MetricManager.instance().value_sequence(
        "Frontend.BackendLagWaitTime")
    n_lag = len(lag.values)
    csm_cuda.LAUNCHES = 0
    threaded = run_async(device, seq, False)
    threaded_launches = csm_cuda.LAUNCHES
    t_slam = threaded["slam"]
    lag_us = lag.values[n_lag:]
    stats = dict(
        scans=len(seq.scans),
        inline=dict(keyframes=len(inline["est"]), loops=inline["loops"],
                    ate_m=inline["ate_m"], wall_s=inline["wall_s"],
                    csm_sweep_launches=inline_launches,
                    cpu_keyframes=len(cpu["est"]), cpu_loops=cpu["loops"],
                    cpu_ate_m=cpu["ate_m"], cpu_wall_s=cpu["wall_s"]),
        threaded=dict(keyframes=len(threaded["est"]),
                      loops=threaded["loops"], ate_m=threaded["ate_m"],
                      wall_s=threaded["wall_s"],
                      csm_sweep_launches=threaded_launches,
                      backend_thread_steps=t_slam.backend_thread_steps,
                      opt_wait_count=t_slam.opt_wait_count,
                      lag_wait_count=t_slam.lag_wait_count,
                      backend_lag_wait_us=dict(
                          count=len(lag_us), sum=sum(lag_us),
                          max=max(lag_us, default=0.0))),
    )
    print(f"async {json.dumps(stats)}", flush=True)
    if (len(cpu["est"]) != len(inline["est"])
            or cpu["loops"] != inline["loops"]
            or not np.array_equal(cpu["est"], inline["est"])):
        raise AssertionError("async inline: the card's run differs from the "
                             "CPU's")
    if inline["loops"] < 1 or not inline["ate_m"] < ASYNC_ATE_MAX:
        raise AssertionError(f"async inline: {stats['inline']}")
    if (t_slam.backend_thread_steps < 1 or t_slam.backend_error is not None
            or not threaded["ate_m"] < ASYNC_ATE_MAX):
        raise AssertionError(f"async threaded: {stats['threaded']}")
    return stats


# Phase 17b, the soak: tests/test_soak.py's course and invariants at the
# factory widths.  The map cache holds at most SOAK_CACHE_ENTRIES maps;
# host RSS may grow by at most SOAK_RSS_MB over the run.
SOAK_CACHE_ENTRIES = 16
SOAK_RSS_MB = 1500
SOAK_LOCAL_MAP_M = 1.5
SOAK_MEMORY_EVERY = 50


def soak_sequence():
    """``tests/test_soak.py``'s course: a 12 m office, 8 laps at 0.3 m, 91
    beams, odometry noise (0.02, 0.008), seed 7."""
    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic

    return synthetic.generate(
        synthetic.World.office(seed=7, size=12.0),
        synthetic.loop_trajectory(size=12.0, laps=8.0, step=0.3),
        n_beams=91, max_range=12.0, range_noise=0.01,
        odom_noise=(0.02, 0.008), seed=7)


def check_soak(device):
    """Phase 17b: the soak on the main path at full width.

    ``create_default_slam`` and ``create_default_backend()`` (the batched
    detector) at the factory widths (1024^2 maps, 512 beams, 768 samples,
    208 thetas, crop 320, the detector's crop 448), inline, with
    ``usable_range_max=12``, a local map every 1.5 m and a map cache of 16
    entries, over :func:`soak_sequence`.  The invariants of
    ``tests/test_soak.py``: at least 300 keyframes, more than 64 local
    maps, at least 10 loop edges, no out-of-extent hit, cache evictions
    and hits with at most 16 entries, host RSS growth below 1,500 MB; ATE
    below odometry's, the other phases' bar.  The JAX test's ATE bars
    (below 0.30 m and half of odometry's) are printed, not required:
    this course misses them in both packages (ROADMAP 3.17; the JAX
    package's own soak reads 0.545 m against odometry's 0.509 m).  The
    card's counterpart of the JAX test's jit-cache bounds: no kernel built
    during the run, and the same number of sweep launches in every
    frontend match without a dense re-run (and that number plus the same
    number per re-run in the others).  Device memory:
    ``memory_allocated`` every 50 keyframes and at the end, and the peak; its growth from keyframe 50 to the end
    stays within a bound computed before the run from the course's
    length: twice the compacted maps' bytes (a u8 prob and a bool
    observed per cell of each local map the course can start) plus 16
    cache entries of three such planes (u8 prob, bool observed, a pooled
    u8 coarse map)."""
    import math

    from my_lidar_graph_slam_v2_tpu_torch.datasets import synthetic
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm_cuda, cuda_build
    from my_lidar_graph_slam_v2_tpu_torch.pipeline.factory import (
        create_default_backend,
        create_default_slam,
    )
    from my_lidar_graph_slam_v2_tpu_torch.utils.memory import (
        physical_memory_usage,
    )

    mm = MetricManager.instance()
    mm.reset_all()
    seq = soak_sequence()
    gt_all = np.asarray(seq.ground_truth)
    travel = float(np.hypot(*np.diff(gt_all[:, :2], axis=0).T).sum())
    backend = create_default_backend(device=device, usable_range_max=12.0,
                                     inline=True)
    cache = backend.loop_detector.map_cache
    cache.max_entries = SOAK_CACHE_ENTRIES
    slam = create_default_slam(
        device=device, usable_range_max=12.0, backend=backend,
        builder_overrides=dict(travel_dist_threshold=SOAK_LOCAL_MAP_M))
    cfg = slam.builder.cfg
    cells = cfg.local_map_rows * cfg.local_map_cols
    max_maps = math.ceil(travel / SOAK_LOCAL_MAP_M) + 1
    mem_bound = 2 * (max_maps * 2 * cells + SOAK_CACHE_ENTRIES * 3 * cells)
    print(f"soak: device-memory growth bound {mem_bound} B "
          f"(2 x ({max_maps} maps x 2 B + {SOAK_CACHE_ENTRIES} entries x "
          f"3 B) x {cells} cells; {travel:.2f} m of travel)", flush=True)

    builds = []
    build = cuda_build.build

    def counted_build(*names):
        out = build(*names)
        builds.extend(n for n, info in out.items() if not info["cached"])
        return out

    matcher = slam.frontend.scan_matcher
    reruns = mm.counter(f"{matcher.name}.DenseFallbacks")
    matches = []

    def counted(fn):
        def match(*args, **kw):
            n0, r0 = csm_cuda.LAUNCHES, reruns.value
            out = fn(*args, **kw)
            matches.append((csm_cuda.LAUNCHES - n0, int(reruns.value - r0)))
            return out
        return match

    steps, detects = [], []
    run_step, detect = backend.run_step, backend.loop_detector.detect

    def timed(fn, into):
        def wrapped(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize(device)
            into.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapped

    matcher.optimize_pose = counted(matcher.optimize_pose)
    matcher.optimize_pose_deltas = counted(matcher.optimize_pose_deltas)
    backend.run_step = timed(run_step, steps)
    backend.loop_detector.detect = timed(detect, detects)
    cuda_build.build = counted_build
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    curve = []
    rss0 = physical_memory_usage()
    csm_cuda.LAUNCHES = 0
    gt = []
    t0 = time.perf_counter()
    try:
        for scan, g in zip(seq.scans, seq.ground_truth):
            if slam.process_scan(scan, scan.odom_pose):
                gt.append(g)
                if len(gt) % SOAK_MEMORY_EVERY == 0:
                    curve.append((len(gt),
                                  torch.cuda.memory_allocated(device)))
        slam.stop_backend()
        torch.cuda.synchronize(device)
    finally:
        cuda_build.build = build
    wall = time.perf_counter() - t0
    launches = csm_cuda.LAUNCHES
    curve.append((len(gt), torch.cuda.memory_allocated(device)))
    peak = torch.cuda.max_memory_allocated(device)
    rss_growth_mb = (physical_memory_usage() - rss0) / 2 ** 20

    est = slam.get_trajectory()
    ate = synthetic.ate_rmse(est, np.asarray(gt))
    odom = np.stack([s.odom_pose for s in seq.scans])
    ate_odom = synthetic.ate_rmse(odom, gt_all[:len(odom)])
    n_kf, n_maps = slam.process_count, len(slam.builder.local_maps)
    n_loops = sum(1 for e in slam.pose_graph.edges if e.is_loop)
    oob = mm.counter("GridMapBuilder.OutOfExtentHits").value
    plain = {n for n, r in matches if r == 0}
    per_rerun = {(n - min(plain, default=0)) / r for n, r in matches if r}
    growth = curve[-1][1] - curve[0][1]
    stats = dict(
        scans=len(seq.scans), keyframes=n_kf, local_maps=n_maps,
        loop_edges=n_loops, ate_m=ate, ate_odom_m=ate_odom,
        jax_soak_ate_bars_met=bool(ate < 0.30 and ate < 0.5 * ate_odom),
        out_of_extent_hits=oob, cache=cache.stats,
        cache_entries=len(cache._entries), rss_growth_mb=rss_growth_mb,
        wall_s=wall, ms_per_keyframe=1e3 * wall / n_kf,
        backend_steps=len(steps),
        backend_step_ms_median=statistics.median(steps),
        backend_step_ms_max=max(steps),
        detects=len(detects),
        detect_ms_median=statistics.median(detects) if detects else None,
        csm_sweep_launches=launches,
        frontend_matches=len(matches),
        frontend_launches_per_match=sorted(plain),
        frontend_launches_per_dense_rerun=sorted(per_rerun),
        frontend_dense_reruns=sum(r for _, r in matches),
        kernels_built_during_run=builds,
        device_memory_bytes=[dict(keyframe=k, allocated=b) for k, b in curve],
        device_memory_growth_bytes=growth,
        device_memory_growth_bound_bytes=mem_bound,
        device_memory_peak_bytes=peak,
    )
    print(f"soak {json.dumps(stats)}", flush=True)
    if n_kf < 300 or n_maps <= 64 or n_loops < 10:
        raise AssertionError(f"soak: {n_kf} keyframes, {n_maps} local maps, "
                             f"{n_loops} loop edges")
    if not ate < ate_odom:
        raise AssertionError(f"soak: ATE {ate}, odometry {ate_odom}")
    if oob != 0:
        raise AssertionError(f"soak: {oob} out-of-extent hits")
    if (cache.stats["evictions"] <= 0 or cache.stats["hits"] <= 0
            or len(cache._entries) > SOAK_CACHE_ENTRIES):
        raise AssertionError(f"soak: map cache {cache.stats}, "
                             f"{len(cache._entries)} entries")
    if not rss_growth_mb < SOAK_RSS_MB:
        raise AssertionError(f"soak: host RSS grew {rss_growth_mb} MB")
    if builds:
        raise AssertionError(f"soak: kernels built during the run: {builds}")
    if len(plain) != 1 or len(per_rerun) > 1:
        raise AssertionError(f"soak: sweep launches per frontend match "
                             f"{sorted(plain)}, per re-run "
                             f"{sorted(per_rerun)}")
    if not growth <= mem_bound:
        raise AssertionError(f"soak: device memory grew {growth} B "
                             f"(bound {mem_bound} B)")
    return stats


def _kernel_line(rows, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
    """Sums of ``keys`` over ``rows``, ``bound_by`` of the larger bound
    and the share of the bound."""
    out = {k: (None if any(r[k] is None for r in rows)
               else sum(r[k] for r in rows)) for k in keys}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    out["pct_of_bound"] = 100 * out["bound_ms"] / out["ms"]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port has no CPU "
              "fallback on this path", file=sys.stderr)
        return 1
    from my_lidar_graph_slam_v2_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    print(f"device: {smi}", flush=True)

    t0 = time.perf_counter()
    built = cuda_build.build("csm_sweep", "csm_sweep_f32", "hit_images")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in built.items():
        print(f"build: {info['path'].name} in {info['seconds']:.2f} s "
              f"(cached={info['cached']})", flush=True)
        for line in info["log"].splitlines():
            print(f"  nvcc: {line}")
    sass = {name: cuda_build.sass_counts(info["path"], "F2F.F64.F32")
            for name, info in built.items()}
    print(f"sass F2F.F64.F32 {json.dumps(sass)}", flush=True)
    f32_sweeps = {k: v for k, v in sass["csm_sweep_f32"].items()
                  if "pack_f32_kernel" not in k}
    if not f32_sweeps or any(f32_sweeps.values()):
        raise AssertionError(f"f32 sweep kernels' F2F.F64.F32: {f32_sweeps}")

    shapes = check_kernel(device)
    f32_shapes = check_f32_kernel(device)
    hit_shapes = check_hit_kernel(device)
    frontend, frontend_launches = check_slice(device)
    loop = check_loop_slice(device)
    corr = check_correlative_loop_slice(device)
    batched, phase7 = check_batched_loop_slice(device, corr)
    cli = check_launcher(device, batched["keyframes"])
    grid = check_grid_search_loop_slice(device)
    hill = check_hill_climbing_frontend(device)
    dist, dist_run = check_distributed_loop_slice(device, phase7, batched)
    nccl = check_multihost_loop_slice(device, phase7, batched)
    two = check_two_ranks(device, phase7, batched, dist_run["slam"])
    h2h = check_head_to_head()
    scripts = check_scripts(device)
    f32_maps = check_f32_maps(device, phase7)
    gather = check_gather_loop_slice(device, corr)
    scatter = check_scatter_slice(device, frontend)
    t17 = time.perf_counter()
    runtime = dict(async_pipeline=check_async_pipeline(device))
    runtime["soak"] = check_soak(device)
    print(f"phase 17: {time.perf_counter() - t17:.2f} s", flush=True)

    # Top-level times: the frontend's two sweeps of a keyframe (coarse +
    # fine), one f32-map correlative loop match's two sweeps and
    # branch-and-bound's hit images; every shape is in "shapes".
    # "launches" is the main path's: create_default_slam with the default
    # (batched) backend, phase 7; for the f32 sweep and its pack their own
    # path, the f32-map matches of phase 14 (one pack per f32 sweep).
    frontend_rows = [r for r in shapes if r["shape"] in ("coarse", "fine")]
    bb_shape = [r for r in hit_shapes if r["shape"] == "branch_bound"]
    print(json.dumps({"kernels": [
        dict(
            name="csm_sweep",
            route="cuda",
            source="my_lidar_graph_slam_v2_tpu_torch/csrc/csm_sweep.cu",
            replaces="my_lidar_graph_slam_v2_tpu/ops/csm_pallas.py:86",
            launches=batched["csm_sweep_launches"],
            launches_by_path=dict(
                frontend=frontend_launches,
                branch_bound_loop=loop["csm_sweep_launches"],
                correlative_loop=corr["csm_sweep_launches"],
                batched_loop=batched["csm_sweep_launches"],
                launcher=cli["csm_sweep_launches"],
                grid_search_loop=grid["csm_sweep_launches"],
                hill_climbing_frontend=hill["csm_sweep_launches"],
                distributed_loop=dist["csm_sweep_launches"],
                multihost_loop=nccl["csm_sweep_launches"],
                multihost_two_ranks=[r["csm_sweep_launches"]
                                     for r in two["ranks"]],
                head_to_head={f"synth{r['seed']}": r["csm_sweep_launches"]
                              for r in h2h},
                bench_csm=scripts["bench_csm"]["csm_sweep_launches"],
                eval_ate={r["config"]: r["csm_sweep_launches"]
                          for r in scripts["eval_ate"]},
                bench_e2e=scripts["bench_e2e"]["csm_sweep_launches"],
                eval_bb_pyramid=scripts["eval_bb_pyramid"][
                    "csm_sweep_launches"],
                eval_scaling=scripts["eval_scaling"]["csm_sweep_launches"],
                eval_scaling_pipeline=scripts["eval_scaling_pipeline"]["p2"][
                    "csm_sweep_launches"],
                gather_loop=gather["csm_sweep_launches"],
                scatter_frontend=scatter["launches"],
                async_inline=runtime["async_pipeline"]["inline"][
                    "csm_sweep_launches"],
                async_threaded=runtime["async_pipeline"]["threaded"][
                    "csm_sweep_launches"],
                soak=runtime["soak"]["csm_sweep_launches"]),
            max_abs_err=max(r["max_abs_err"] for r in shapes),
            **_kernel_line(frontend_rows),
            shapes=shapes,
        ),
        dict(
            name="csm_sweep_f32",
            route="cuda",
            source="my_lidar_graph_slam_v2_tpu_torch/csrc/csm_sweep_f32.cu",
            replaces="my_lidar_graph_slam_v2_tpu/ops/csm_pallas.py:86",
            launches=f32_maps["f32_sweep_launches"],
            launches_by_path=dict(
                f32_maps={k: m["f32_launches_per_match"] * m["matches"]
                          for k, m in f32_maps["matchers"].items()},
                f32_maps_below_2_18={
                    k: m["f32"] for k, m in
                    f32_maps["small_cells"]["matchers"].items()},
                gather_loop=gather["f32_sweep_launches"]),
            max_abs_err=max(r["max_abs_err"] for r in f32_shapes),
            **_kernel_line([r for r in f32_shapes
                            if r["shape"] in ("loop_coarse", "loop_fine")]),
            shapes=f32_shapes,
        ),
        dict(
            name="csm_sweep_f32_pack",
            route="cuda",
            source="my_lidar_graph_slam_v2_tpu_torch/csrc/csm_sweep_f32.cu",
            replaces="my_lidar_graph_slam_v2_tpu/ops/csm_pallas.py:86",
            launches=f32_maps["f32_pack_launches"],
            launches_by_path=dict(
                f32_maps=f32_maps["f32_pack_launches"],
                f32_maps_below_2_18=sum(
                    m["pack"] for m in
                    f32_maps["small_cells"]["matchers"].values())),
            max_abs_err=max(r["pack"]["max_abs_err"] for r in f32_shapes),
            **_kernel_line([r["pack"] for r in f32_shapes
                            if r["shape"] in ("loop_coarse", "loop_fine")]),
        ),
        dict(
            name="hit_images",
            route="cuda",
            source="my_lidar_graph_slam_v2_tpu_torch/csrc/hit_images.cu",
            replaces="my_lidar_graph_slam_v2_tpu/ops/csm_pallas.py:32",
            launches=loop["hit_image_launches"],
            launches_by_path=dict(
                branch_bound_loop=loop["hit_image_launches"],
                batched_loop=batched["hit_image_launches"],
                launcher=cli["hit_image_launches"],
                head_to_head={f"synth{r['seed']}": r["hit_image_launches"]
                              for r in h2h},
                eval_ate={r["config"]: r["hit_image_launches"]
                          for r in scripts["eval_ate"]},
                f32_maps_below_2_18=f32_maps["small_cells"]["matchers"][
                    "branch_bound"]["hits"]),
            max_abs_err=max(r["max_abs_err"] for r in hit_shapes),
            **_kernel_line(bb_shape),
            shapes=hit_shapes,
        ),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
