"""The dense gated sweep against pyramid-pruned branch-and-bound at the
loop window.

Port of the JAX package's ``scripts/eval_bb_pyramid.py``::

    python -m my_lidar_graph_slam_v2_tpu_torch.scripts.eval_bb_pyramid \\
        [--device cuda] [--iters 10] [--out F]

The JAX script's workload: a 1024 x 1024 u8 map at 5 cm, a scan of 512
beams (0.5-8 m), 128 thetas over 0.5 rad, crop 448, a 25-cell window each
way (2.5 m) and pyramid height 3 (8-cell blocks).  Two maps: uniform
noise, where every block bound looks alike and pruning does nothing
(branch-and-bound's worst case), and a map peaked at the scan's own
endpoints (a loop closure's common case).  Three things are timed:

- ``dense``: the whole 56 x 56-offset window in one sweep
  (``ops/csm.py:csm_sweep``; one kernel launch on the card), the port's
  dense matcher's form;
- ``bb_best_case``: branch-and-bound's best case as dense steps, the
  pyramid to the top level, hit images, the bound sweep and the fine sweep
  of the one best block (``ops/csm.py:sweep_from_hits``);
- the port's ``branch_bound_core`` on each map (thresholds 0.1 and 0.05).

Times come from CUDA events around ``--iters`` calls after a warm-up (on
the CPU, with ``--device cpu``, from the host clock).  Prints one JSON
object with the card's name and power limit; writes it only to ``--out``.
Beside the times it reports the best block of the bound sweep, the blocks
branch-and-bound swept, and on each map branch-and-bound's score beside
the dense sweep's gated argmax, which it must equal.  The device defaults
to the card and the script exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from . import common

RES = 0.05
SCORE_THRESHOLD = 0.1
KNOWN_RATE_THRESHOLD = 0.05


def build_inputs(size=1024, beams=512, seed=0):
    """NumPy inputs of the JAX script: ranges, angles, the map-local pose,
    the raster offset and the two maps as (prob u8, observed bool) pairs.
    The ranges reach 8 m, or 40 % of a smaller map's width."""
    rng = np.random.default_rng(seed)
    H = W = size
    max_range = min(8.0, 0.4 * size * RES)
    ranges = rng.uniform(0.5, max_range, beams).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, beams).astype(np.float32)
    pose = np.float32([0.1, -0.1, 0.05])
    off = np.float32([-H * RES / 2, -W * RES / 2])
    prob_f = rng.uniform(0, 1, (H, W)).astype(np.float32)
    obs_noise = prob_f > 0.5
    prob_noise = np.where(obs_noise, np.round(prob_f * 255), 0).astype(np.uint8)
    ex = 0.1 + ranges * np.cos(0.05 + angles)
    ey = -0.1 + ranges * np.sin(0.05 + angles)
    rr = np.clip(((ey - off[1]) / RES).astype(int), 0, H - 1)
    cc = np.clip(((ex - off[0]) / RES).astype(int), 0, W - 1)
    pk = np.full((H, W), 40, np.uint8)
    pk[rr, cc] = 240
    obs_peak = np.zeros((H, W), bool)
    obs_peak[max(rr.min() - 50, 0):rr.max() + 50,
             max(cc.min() - 50, 0):cc.max() + 50] = True
    prob_peak = np.where(obs_peak, pk, 0).astype(np.uint8)
    return dict(ranges=ranges, angles=angles, pose=pose, off=off,
                maps=dict(noise=(prob_noise, obs_noise),
                          peaked=(prob_peak, obs_peak)))


def _timer(device, iters):
    """ms per call of a function: CUDA events around ``iters`` calls after
    one warm-up call on the card, the host clock on the CPU."""

    def timed(fn):
        fn()
        common.sync(device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    return timed


def run(device, *, size=1024, beams=512, thetas=128, crop=448, win=25,
        height=3, iters=10, seed=0):
    """The measurement on ``device``; returns the result dict."""
    from ..matching.branch_bound import BranchBoundConfig, branch_bound_core
    from ..ops import csm, pool

    device = torch.device(device)
    inp = build_inputs(size, beams, seed)
    t = {k: torch.as_tensor(inp[k], device=device)
         for k in ("ranges", "angles", "pose", "off")}
    mask = torch.ones(beams, dtype=torch.bool, device=device)
    maps = {k: tuple(torch.as_tensor(a, device=device) for a in v)
            for k, v in inp["maps"].items()}
    block = 1 << height
    nb = (2 * win) // block + 1
    nf = nb * block
    x0 = y0 = -win
    step, t0, tmask = csm.theta_search_params(t["ranges"], mask, RES, 0.5,
                                              thetas)
    # branch_bound_core's f32 normalisation, so the gates compare alike
    norm = 1.0 / torch.tensor(float(beams), device=device)
    timed = _timer(device, iters)

    def hits():
        hr, hc, valid, r0, c0 = csm.beam_cells(
            t["ranges"], t["angles"], mask, t["pose"], t0, step, tmask, RES,
            t["off"], n_theta=thetas, crop_rows=crop, crop_cols=crop)
        return csm.build_hit_images(hr, hc, valid, tmask, crop_rows=crop,
                                    crop_cols=crop), r0, c0

    def dense(prob, obs):
        return csm.csm_sweep(
            prob, obs, t["ranges"], t["angles"], mask, t["pose"], t0, step,
            tmask, x0, y0, RES, t["off"], n_theta=thetas, nx=nf, ny=nf,
            crop_rows=crop, crop_cols=crop, precision="split")

    def best_case(prob, obs):
        img, r0, c0 = hits()
        pyr_p = pool.pyramid(prob, height)[-1]
        pyr_o = pool.pyramid(obs, height)[-1]
        cs, ck = csm.sweep_from_hits(img, r0, c0, pyr_p, pyr_o, x0, y0,
                                     nx=nb, ny=nb, stride=block,
                                     precision="split")
        best = torch.argmax(cs.reshape(-1))
        bj, bi = (best // nb) % nb, best % nb
        fs, fk = csm.sweep_from_hits(img, r0, c0, prob, obs,
                                     x0 + bi * block, y0 + bj * block,
                                     nx=block, ny=block, stride=1,
                                     precision="split")
        return bj, bi, fs.max() + fk.max() + ck.max()

    bcfg = BranchBoundConfig(node_height_max=height, range_x=2 * win * RES,
                             range_y=2 * win * RES, range_theta=0.5,
                             resolution=RES, n_theta_max=thetas,
                             crop_rows=crop, crop_cols=crop)
    out = dict(common.card(device), window_cells=2 * win,
               theta_candidates=thetas, pyramid_height=height, map_size=size,
               beams=beams, crop=crop, iters=iters)
    prob, obs = maps["noise"]
    out["dense_sweep_ms"] = timed(lambda: dense(prob, obs))
    out["bb_best_case_ms"] = timed(lambda: best_case(prob, obs))
    bj, bi, _ = best_case(prob, obs)
    out["best_block"] = [int(bj), int(bi)]
    for name, (prob, obs) in maps.items():
        pp = pool.pyramid(prob, bcfg.bound_height)[-1]
        po = pool.pyramid(obs, bcfg.bound_height)[-1]
        swept = []

        def matcher():
            res, stats = branch_bound_core(
                bcfg, prob, obs, pp, po, t["ranges"], t["angles"], mask,
                t["pose"], t["off"], SCORE_THRESHOLD, KNOWN_RATE_THRESHOLD)
            swept.append(stats["blocks_swept"])
            return res

        out[f"bb_matcher_{name}_map_ms"] = timed(matcher)
        _, score, found, _, _ = (float(v) if v.numel() == 1 else v
                                 for v in matcher())
        scores, known = dense(prob, obs)
        elig = tmask[:, None, None] & (known * norm > KNOWN_RATE_THRESHOLD)
        gated = float(torch.where(elig, scores, -math.inf).max() * norm)
        out[f"{name}_map"] = dict(
            bb_blocks_swept=swept[-1], bb_blocks=nb * nb, bb_found=bool(found),
            bb_score=score, dense_gated_best_score=gated,
            dense_found=gated > SCORE_THRESHOLD)
    for name in maps:
        out[f"bb_speedup_vs_dense_{name}"] = (
            out["dense_sweep_ms"] / out[f"bb_matcher_{name}_map_ms"])
    out["conclusion"] = (
        "branch-and-bound (bound-ordered block descent, "
        "matching/branch_bound.py) against the dense sweep of the whole loop "
        "window: the peaked map's bounds prune most blocks, the noise map's "
        "prune few; compare the rows of one run only")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu only when asked "
                    "for)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--size", type=int, default=1024,
                    help="map rows and columns (default: the JAX script's)")
    ap.add_argument("--beams", type=int, default=512)
    ap.add_argument("--thetas", type=int, default=128)
    ap.add_argument("--crop", type=int, default=448)
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    device = common.script_device(args.device, "eval_bb_pyramid")
    out = run(device, size=args.size, beams=args.beams, thetas=args.thetas,
              crop=args.crop, iters=args.iters)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
