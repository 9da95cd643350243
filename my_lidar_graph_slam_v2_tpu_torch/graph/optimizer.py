"""Batched SE(2) pose-graph optimization (Levenberg-Marquardt).

Port of ``my_lidar_graph_slam_v2_tpu/graph/optimizer.py``
(``mapping/pose_graph_optimizer_lm.cpp``): a bipartite graph of local-map
nodes and scan nodes; edge error ``e = h(c_i, c_j) - z`` with ``h`` the
scan node's pose in the map node's frame; robust IRLS weights on loop
edges only; the gauge fixed by hard elimination of the first map node;
lambda halved on an accepted step and doubled on a rejected one, and kept
across calls.  The normal equations are solved either densely or by the
Schur complement over the scan nodes (the default).

The JAX package pads every shape to a power-of-two bucket so XLA compiles
O(log E) programs; eager PyTorch compiles nothing, so the shapes here are
the graph's own.  All ``num_iterations_max`` LM steps run masked, the
state frozen once the stop test fires, so the loop needs no host sync per
iteration: one fetch returns the result.

The inputs arrive in f32, as in the JAX package.  The LM runs in f64 on
``utils/devmath.py``'s functions and rounds the poses and errors it
returns to f32 once, so the CPU and CUDA (LAPACK and cuSOLVER,
scatter-adds in any order) give the same poses.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..metrics.registry import MetricManager
from ..utils import devmath
from ..utils.transfer import fetch, to_device
from .loss import LossFunction


@dataclass(frozen=True)
class OptimizerConfig:
    """Field for field the JAX package's ``OptimizerConfig``."""

    solver: str = "schur"  # "dense" | "schur"
    num_iterations_max: int = 10
    error_tolerance: float = 1e-4
    initial_lambda: float = 1e-4
    loss: LossFunction = field(default_factory=LossFunction)
    # Max spectral norm of an edge's information matrix (the reference's
    # 1e9 pins are catastrophic in f32).
    info_clip: float = 1e5


def _edge_errors_jacobians(map_poses, scan_poses, map_idx, scan_idx, rel):
    """Errors and Jacobians of all edges
    (``ComputeErrorAndJacobians``, pose_graph_optimizer_lm.cpp:380-415)."""
    sp = map_poses[map_idx]
    ep = scan_poses[scan_idx]
    st, ct = devmath.sin(sp[:, 2]), devmath.cos(sp[:, 2])
    d = ep - sp
    x = ct * d[:, 0] + st * d[:, 1]
    y = -st * d[:, 0] + ct * d[:, 1]
    et = d[:, 2] - rel[:, 2]
    et = devmath.atan2(devmath.sin(et), devmath.cos(et))
    e = torch.stack([x - rel[:, 0], y - rel[:, 1], et], dim=-1)
    zeros = torch.zeros_like(ct)
    ones = torch.ones_like(ct)
    Js = torch.stack([
        torch.stack([-ct, -st, y], -1),
        torch.stack([st, -ct, -x], -1),
        torch.stack([zeros, zeros, -ones], -1),
    ], dim=-2)
    Je = torch.stack([
        torch.stack([ct, st, zeros], -1),
        torch.stack([-st, ct, zeros], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=-2)
    return e, Js, Je


def _chi2(e, info):
    return torch.einsum("ei,eij,ej->e", e, info, e)


def _edge_blocks(map_poses, scan_poses, map_idx, scan_idx, rel, info,
                 is_loop, loss):
    e, Js, Je = _edge_errors_jacobians(map_poses, scan_poses, map_idx,
                                       scan_idx, rel)
    chi2 = _chi2(e, info)
    w = torch.where(is_loop > 0, loss.weight(chi2), 1.0)
    winfo = info * w[:, None, None]
    JsT_i = Js.transpose(1, 2) @ winfo
    JeT_i = Je.transpose(1, 2) @ winfo
    Hss = JsT_i @ Js
    Hee = JeT_i @ Je
    Hse = JsT_i @ Je
    bs = -(JsT_i @ e[:, :, None])[:, :, 0]
    be = -(JeT_i @ e[:, :, None])[:, :, 0]
    return Hss, Hee, Hse, bs, be


def _total_error(map_poses, scan_poses, map_idx, scan_idx, rel, info, loss):
    """Robust total error (``ComputeTotalError``): the loss applies to
    every edge, while the IRLS weights gate loop edges only."""
    e, _, _ = _edge_errors_jacobians(map_poses, scan_poses, map_idx,
                                     scan_idx, rel)
    return loss.loss(_chi2(e, info)).sum()


def _block_index(rows, cols):
    """Flat-matrix row/col index grids of 3x3 blocks at node rows/cols."""
    k = torch.arange(3, device=rows.device)
    r = rows[:, None, None] * 3 + k[None, :, None]
    c = cols[:, None, None] * 3 + k[None, None, :]
    return r.expand(-1, 3, 3), c.expand(-1, 3, 3)


def _solve_pos(H, b):
    """``jax.scipy.linalg.solve(H, b, assume_a="pos")`` without a host
    sync: Cholesky, NaN where the factorization fails (as JAX's does), so
    the LM step is rejected like any uphill step."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, float("nan"))


def _fix_gauge(H, b):
    """Hard-fix the first map node: zero its rows and columns, identity on
    its diagonal block, zero right-hand side."""
    n = H.shape[0]
    keep = torch.arange(n, device=H.device) >= 3
    H = torch.where(keep[:, None] & keep[None, :], H, 0.0)
    H = H + torch.diag((~keep).to(H.dtype))
    return H, torch.where(keep, b, 0.0)


def _solve_dense(n_maps, n_scans, Hss, Hee, Hse, bs, be, map_idx, scan_idx,
                 lam):
    nv = 3 * (n_maps + n_scans)
    dev, dt = Hss.device, Hss.dtype
    H = torch.zeros((nv, nv), dtype=dt, device=dev)
    b = torch.zeros((nv,), dtype=dt, device=dev)
    sm = map_idx
    se = n_maps + scan_idx
    for blocks, (bi, bj) in ((Hss, (sm, sm)), (Hee, (se, se)),
                             (Hse, (sm, se)), (Hse.transpose(1, 2), (se, sm))):
        H.index_put_(_block_index(bi, bj), blocks, accumulate=True)
    k = torch.arange(3, device=dev)
    b.index_put_(((sm[:, None] * 3 + k[None, :]),), bs, accumulate=True)
    b.index_put_(((se[:, None] * 3 + k[None, :]),), be, accumulate=True)
    H = H + lam * torch.eye(nv, dtype=dt, device=dev)
    H, b = _fix_gauge(H, b)
    dp = _solve_pos(H, b)
    return (dp[: 3 * n_maps].reshape(n_maps, 3),
            dp[3 * n_maps:].reshape(n_scans, 3))


def _segment_sum(x, idx, n):
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def _solve_schur(n_maps, n_scans, Hss, Hee, Hse, bs, be, map_idx, scan_idx,
                 pair_e1, pair_e2, lam):
    """Schur-complement solve: eliminate the scan nodes (each edge touches
    exactly one), solve the reduced map-node system, back-substitute.
    ``pair_e1/pair_e2`` list the ordered pairs of edges that share a scan
    node, diagonal pairs included; they give the reduced system's fill-in."""
    dev, dt = Hss.device, Hss.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    Hee_n = _segment_sum(Hee, scan_idx, n_scans) + lam * eye
    be_n = _segment_sum(be, scan_idx, n_scans)
    Hee_inv = devmath.inv(Hee_n)

    W = Hse @ Hee_inv[scan_idx]
    bm = _segment_sum(bs, map_idx, n_maps)
    bm_red = bm - _segment_sum(
        (W @ be_n[scan_idx][:, :, None])[:, :, 0], map_idx, n_maps
    )

    nv = 3 * n_maps
    Hm = torch.zeros((nv, nv), dtype=dt, device=dev)
    Hm.index_put_(_block_index(map_idx, map_idx), Hss, accumulate=True)
    fill = -(W[pair_e1] @ Hse[pair_e2].transpose(1, 2))
    Hm.index_put_(_block_index(map_idx[pair_e1], map_idx[pair_e2]), fill,
                  accumulate=True)
    Hm = Hm + lam * torch.eye(nv, dtype=dt, device=dev)
    Hm, bm_flat = _fix_gauge(Hm, bm_red.reshape(-1))
    dpm = _solve_pos(Hm, bm_flat).reshape(n_maps, 3)
    # dps_j = Hee_j^-1 (be_j - sum_{e: scan_e = j} Hse_e^T dpm(map_e))
    cross = _segment_sum(
        (Hse.transpose(1, 2) @ dpm[map_idx][:, :, None])[:, :, 0],
        scan_idx, n_scans,
    )
    dps = (Hee_inv @ (be_n - cross)[:, :, None])[:, :, 0]
    return dpm, dps


def schur_pairs(scan_idx: np.ndarray):
    """Ordered pairs ``(a, b)`` of edges sharing a scan node, ``a == b``
    included: for each scan node of degree k, its k^2 pairs.  Vectorized
    (the JAX package enumerates them in a Python double loop)."""
    scan_idx = np.asarray(scan_idx, np.int64)
    order = np.argsort(scan_idx, kind="stable")
    _, start, k = np.unique(scan_idx[order], return_index=True,
                            return_counts=True)
    g = np.repeat(np.arange(len(k)), k * k)
    local = np.arange(len(g)) - np.repeat(np.cumsum(k * k) - k * k, k * k)
    a = order[start[g] + local // k[g]]
    b = order[start[g] + local % k[g]]
    return a, b


def optimize_core(cfg: OptimizerConfig, n_maps, n_scans, map_poses,
                  scan_poses, map_idx, scan_idx, is_loop, rel, info, pair_e1,
                  pair_e2, lam0):
    """Port of ``_optimize_core``: ``num_iterations_max`` masked LM steps
    in f64; returns (map poses, scan poses, error, lambda, iterations,
    initial error) as device tensors, the poses and errors rounded to f32."""
    loss = cfg.loss
    dev = map_poses.device
    map_poses, scan_poses, rel, info = (
        a.to(torch.float64) for a in (map_poses, scan_poses, rel, info)
    )

    def total(mp, sp):
        # The f32 error, as the JAX package compares it: rounding the f64
        # sum also removes its device-dependent last bits, so accept and
        # stop decide the same on every device.
        return _total_error(mp, sp, map_idx, scan_idx, rel, info,
                            loss).to(torch.float32)

    mp, sp = map_poses, scan_poses
    err = total(mp, sp)
    init_err = err
    lam = torch.full((), lam0, dtype=torch.float64, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(cfg.num_iterations_max):
        Hss, Hee, Hse, bs, be = _edge_blocks(
            mp, sp, map_idx, scan_idx, rel, info, is_loop, loss
        )
        if cfg.solver == "dense":
            dpm, dps = _solve_dense(n_maps, n_scans, Hss, Hee, Hse, bs, be,
                                    map_idx, scan_idx, lam)
        else:
            dpm, dps = _solve_schur(n_maps, n_scans, Hss, Hee, Hse, bs, be,
                                    map_idx, scan_idx, pair_e1, pair_e2, lam)
        mp2, sp2 = mp + dpm, sp + dps
        err2 = total(mp2, sp2)
        # LM accept/reject (pose_graph_optimizer_lm.cpp:88-94); a NaN
        # error (failed Cholesky) compares False and is rejected.
        good = err2 < err
        it2 = it + 1
        lam2 = torch.where(good, lam * 0.5, lam * 2.0)
        stop = ((it2 >= cfg.num_iterations_max)
                | (good & (err - err2 < cfg.error_tolerance))
                | (lam2 > 1e12))
        take = good & ~done
        mp = torch.where(take, mp2, mp)
        sp = torch.where(take, sp2, sp)
        err = torch.where(take, err2, err)
        lam = torch.where(done, lam, lam2)
        it = torch.where(done, it, it2)
        done = done | stop
    return (mp.to(torch.float32), sp.to(torch.float32), err, lam, it,
            init_err)


class PoseGraphOptimizer:
    """Host wrapper: clips edge information, enumerates the Schur pairs,
    and keeps the persistent lambda (the reference keeps ``mLambda``
    across Optimize() calls)."""

    def __init__(self, cfg: OptimizerConfig = OptimizerConfig(), *, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.lam = cfg.initial_lambda
        vs = MetricManager.instance().value_sequence
        pre = "PoseGraphOptimizerLM."
        self._m = {
            n: vs(pre + n)
            for n in ("NumOfIterations", "InitialError", "FinalError",
                      "NumOfLocalMapNodes", "NumOfScanNodes", "NumOfEdges")
        }

    def optimize(self, map_poses, scan_poses, edges):
        """edges = (map_idx, scan_idx, is_loop, rel, info) as NumPy arrays.
        Returns (map_poses, scan_poses, stats dict)."""
        map_idx, scan_idx, is_loop, rel, info = edges
        M, N, E = len(map_poses), len(scan_poses), len(map_idx)
        if E == 0:
            return map_poses, scan_poses, dict(iterations=0, error=0.0)
        info = np.array(info, np.float32)
        # Clip the information's spectral norm (see cfg.info_clip)
        norms = np.linalg.norm(info, ord=2, axis=(1, 2))
        big = norms > self.cfg.info_clip
        if big.any():
            info[big] *= (self.cfg.info_clip / norms[big])[:, None, None]
        p1, p2 = schur_pairs(scan_idx)
        dev = self.device
        mp, sp, err, lam, iters, init_err = fetch(optimize_core(
            self.cfg, M, N,
            to_device(map_poses, dev, np.float32),
            to_device(scan_poses, dev, np.float32),
            to_device(map_idx, dev, np.int64),
            to_device(scan_idx, dev, np.int64),
            to_device(is_loop, dev, np.int32),
            to_device(rel, dev, np.float32),
            to_device(info, dev, np.float32),
            to_device(p1, dev, np.int64),
            to_device(p2, dev, np.int64),
            float(np.float32(self.lam)),
        ))
        self.lam = float(lam)
        stats = dict(iterations=int(iters), error=float(err),
                     initial_error=float(init_err))
        self._m["NumOfIterations"].observe(stats["iterations"])
        self._m["InitialError"].observe(stats["initial_error"])
        self._m["FinalError"].observe(stats["error"])
        self._m["NumOfLocalMapNodes"].observe(M)
        self._m["NumOfScanNodes"].observe(N)
        self._m["NumOfEdges"].observe(E)
        return mp, sp, stats
