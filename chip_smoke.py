#!/usr/bin/env python3
"""Build the PyTorch port's kernels on one NVIDIA GPU, time them at the
shapes the system runs, then run the card's test suite.

    python3 chip_smoke.py            # from the root of a checkout

1. Device: requires CUDA (there is no CPU fallback) and prints the card's
   name and power limit as ``nvidia-smi`` reports them.
2. Build: compiles ``csrc/csm_sweep.cu``, ``csrc/csm_sweep_f32.cu``,
   ``csrc/hit_images.cu`` and ``csrc/gauss_newton.cu`` with nvcc for
   sm_90a from the checkout's sources, all at once, and prints the build
   times and ptxas reports.
3. Kernel times: each kernel at every shape the system runs, on the
   seeded inputs of ``tests/torch_card_cases.py`` (the sweep at
   :func:`kernel_shapes`, its f32 form and pack at ``F32_SHAPES`` on the
   "split" window) and ``tests/torch_gn_cases.py`` (the Gauss-Newton
   refinement at the frontend's and the loop final matcher's shapes on
   1024^2 maps, u8 and f32), and the hit images at branch-and-bound's
   shape, the frontend crop and a degenerate one.  Device ms from
   CUDA-graph replays (:func:`_graph_ms`) beside the bound (each input
   byte read once, each output byte written once, the operations these
   inputs need; ``scripts/common.py``'s peaks), the plain version's ms on
   the card and one library call's (``F.conv2d`` for a one-tile sweep,
   ``torch.bincount`` for the hit images; none computes the rest).  One
   JSON line ``{"kernels": [...]}``.
4. The card suite, ``python -m pytest --noconftest -m cuda
   tests/test_torch_cuda*.py`` in a subprocess: every kernel against its
   plain version, every system on the card against the same system on the
   CPU, the launch contracts and the runs' bars.  Only if it passes does
   the last line read ``{"ok": true, "device": {...}}``; otherwise the exit
   code is pytest's.

One test alone: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda*.py -k NAME``.  Per-layer times of the system on the
card come from the benchmark, ``python3 -m slam_bench.run ... --trace 1``.

Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from my_lidar_graph_slam_v2_tpu_torch.scripts.common import (
    F32_OPS_PER_S,
    F64_OPS_PER_S,
    bound as _bound,
    nvidia_smi as _nvidia_smi,
    sweep_bound,
)

ROOT = Path(__file__).resolve().parent
# The card's Python has a foreign top-level ``tests`` package, so the test
# helpers are imported by their own names, as pytest imports them.
sys.path.insert(0, str(ROOT / "tests"))
import torch_card_cases as cases  # noqa: E402

TIMED_RUNS = 20
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


def sweep_library_call(win, hr, hc, ok, s):
    """One PyTorch call for a sweep of one tile at the window's origin:
    ``F.conv2d`` of the f32 windows (``win`` ``[N, in_r, in_c, 2]``; the
    two channels as the batch, the N candidates as the channels) with the
    prebuilt hit images as T filters per candidate (``groups=N``) at the
    tile's stride (cuDNN TF32 off); None for sweeps of tile lists, which no
    one call computes."""
    import torch.nn.functional as F

    from my_lidar_graph_slam_v2_tpu_torch.ops import csm

    if s["origins"].shape[1] != 1 or s["origins"].any():
        return None
    N, stride = s["N"], s["tile"][2]
    hits = torch.cat([csm.hit_images_plain(
        torch.where(ok[n], hr[n], -1), hc[n],
        crop_rows=s["crop"], crop_cols=s["crop"]) for n in range(N)])[:, None]
    x = win.permute(3, 0, 1, 2).to(torch.float32)
    return lambda: F.conv2d(x, hits, stride=stride, groups=N)


def time_sweeps(device, f32=False):
    """Rows of the sweep kernel on u8 windows at every shape of
    :func:`torch_card_cases.kernel_shapes`, or (``f32``) of its f32 form at
    ``F32_SHAPES`` on the window rounded as precision "split" rounds it:
    the pack and the sweep, and the pack alone under ``pack`` (it reads 8 B
    and writes 8 B a cell, one f32 multiply each)."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda

    kernel = csm_cuda.csm_sweep_f32 if f32 else csm_cuda.csm_sweep
    rows = []
    for s in cases.kernel_shapes():
        name = s["shape"]
        if f32 and name not in cases.F32_SHAPES:
            continue
        win, hr, hc, ok, origins, (th, tw, stride), _ = cases.tile_case(name)
        if f32:
            win = cases.f32_window(win, cases.ALL_CASES.index(name), "split")
        args = tuple(torch.as_tensor(a, device=device)
                     for a in (win, hr, hc, ok, origins))
        kw = dict(tile_h=th, tile_w=tw, stride=stride)
        ms = _graph_ms(lambda: kernel(*args, **kw))
        bound_ms, bound_by = sweep_bound(s, args[3], f32=f32)
        lib = sweep_library_call(*args[:4], s)
        row = dict(
            kernel=kernel.__name__, shape=name, N=s["N"], T=s["T"], B=s["B"],
            crop=s["crop"], tile=list(s["tile"]),
            tiles=int(s["origins"].shape[1]), n_off=s["n_off"], ms=ms,
            plain_ms=_events_ms(lambda: csm.sweep_tiles_plain(*args, **kw)),
            bound_ms=bound_ms, bound_by=bound_by,
            pct_of_bound=100 * bound_ms / ms,
            library_ms=None if lib is None else _events_ms(lib))
        if f32:
            w, cells = args[0], args[0].numel() // 2
            pack_ms = _graph_ms(lambda: csm_cuda.csm_pack_f32(w))
            pb_ms, pb_by = _bound(16 * cells, cells, F32_OPS_PER_S)
            row["pack"] = dict(
                ms=pack_ms,
                plain_ms=_events_ms(lambda: csm.pack_f32_window_plain(w)),
                bound_ms=pb_ms, bound_by=pb_by,
                pct_of_bound=100 * pb_ms / pack_ms)
        rows.append(row)
    return rows


def time_hit_images(device):
    """Rows of the hit-image kernel at branch-and-bound's shape (T 208, B
    512, crop 448), at the frontend crop 320, and with 300 beams of every
    theta in one cell; about 5 % of the pairs dropped as row -1 and 5 %
    with an out-of-crop column.  Library: one ``torch.bincount`` of the
    flat (theta, row, col) keys."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, hit_images_cuda

    rng = np.random.default_rng(2)
    rows_out = []
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
        inside = (rows >= 0) & (rows < crop) & (cols >= 0) & (cols < crop)
        t = torch.arange(T, device=device)[:, None]
        keys = ((t * crop + rows) * crop + cols)[inside]
        ms = _graph_ms(lambda: hit_images_cuda.hit_images(rows, cols, **kw))
        # bytes: rows and cols read, the f32 image written; one f32 add
        # per pair in the crop
        bound_ms, bound_by = _bound(T * B * 8 + T * crop * crop * 4,
                                    int(inside.sum()), F32_OPS_PER_S)
        rows_out.append(dict(
            kernel="hit_images", shape=name, T=T, B=B, crop=crop, ms=ms,
            plain_ms=_events_ms(
                lambda: csm.hit_images_plain(rows, cols, **kw)),
            bound_ms=bound_ms, bound_by=bound_by,
            pct_of_bound=100 * bound_ms / ms,
            library_ms=_events_ms(
                lambda: torch.bincount(keys, minlength=T * crop * crop))))
    return rows_out


# Bytes one Gauss-Newton evaluation reads per beam: range and angle (f32),
# mask (bool) and four corners of the raster and of its observed mask; f64
# operations per beam: the 10 products and 10 adds of (W K)^T K (2 more for
# the initial cost's sum of squares in the first evaluation).
GN_BEAM_BYTES = {torch.uint8: 4 + 4 + 1 + 4 * (1 + 1),
                 torch.float32: 4 + 4 + 1 + 4 * (4 + 1)}
GN_BEAM_F64_OPS = 20
GN_MAP_SIZE = 1024


def gn_bound(prob, beams, iterations):
    """Bound of one refinement that ran ``iterations`` steps: its
    ``1 + iterations`` evaluations' bytes and f64 operations, the pose,
    offset and output once."""
    evals = 1 + iterations
    nbytes = evals * beams * GN_BEAM_BYTES[prob.dtype] + 12 + 8 + 64
    ops = evals * beams * GN_BEAM_F64_OPS + 2 * beams
    return _bound(nbytes, ops, F64_OPS_PER_S)


def time_gauss_newton(device):
    """Rows of the Gauss-Newton kernel at the course's frontend and loop
    cases on 1024^2 maps, u8 and f32; the plain version's ms on the card
    (no library call computes it)."""
    import torch_gn_cases as gn_cases

    from my_lidar_graph_slam_v2_tpu_torch.ops import (
        gauss_newton,
        gauss_newton_cuda,
    )

    rows = []
    for shape in ("frontend", "loop"):
        for f32 in (False, True):
            args = gn_cases.case(shape, f32=f32, size=GN_MAP_SIZE)
            on = [a.to(device) if torch.is_tensor(a) else a for a in args]
            kw = dict(max_iterations=10, convergence_threshold=1e-4,
                      initial_lambda=1e-4, covariance_scale=1e4)
            iterations = int(gauss_newton_cuda.refine(*on, **kw)[2])
            ms = _graph_ms(lambda: gauss_newton_cuda.refine(*on, **kw))
            bound_ms, bound_by = gn_bound(args[0], args[2].shape[0],
                                          iterations)
            rows.append(dict(
                kernel="gauss_newton", shape=shape,
                raster="f32" if f32 else "u8", map=list(args[0].shape),
                B=int(args[2].shape[0]), valid=int(args[4].sum()),
                iterations=iterations, ms=ms,
                plain_ms=_events_ms(
                    lambda: gauss_newton.refine_plain(*on), calls=5),
                bound_ms=bound_ms, bound_by=bound_by,
                pct_of_bound=100 * bound_ms / ms, library_ms=None))
    return rows


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
    built = cuda_build.build("csm_sweep", "csm_sweep_f32", "hit_images",
                             "gauss_newton")
    print(f"build: all kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in built.items():
        print(f"build: {info['path'].name} in {info['seconds']:.2f} s "
              f"(cached={info['cached']})", flush=True)
        for line in info["log"].splitlines():
            print(f"  nvcc: {line}")

    t0 = time.perf_counter()
    rows = (time_sweeps(device) + time_sweeps(device, f32=True)
            + time_hit_images(device) + time_gauss_newton(device))
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"kernel times: {time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    rc = subprocess.call(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider",
         *sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "tests").glob("test_torch_cuda*.py"))],
        cwd=ROOT)
    print(f"card suite: exit {rc} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if rc != 0:
        return rc
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
