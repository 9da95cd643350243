"""Batched SE(2) pose-graph optimization (Levenberg-Marquardt).

Port of ``my_lidar_graph_slam_v2_tpu/graph/optimizer.py``
(``mapping/pose_graph_optimizer_lm.cpp``): a bipartite graph of local-map
nodes and scan nodes; edge error ``e = h(c_i, c_j) - z`` with ``h`` the
scan node's pose in the map node's frame; robust IRLS weights on loop
edges only; the gauge fixed by hard elimination of the first map node;
lambda halved on an accepted step and doubled on a rejected one, and kept
across calls.  The normal equations are solved either densely or by the
Schur complement over the scan nodes (the default), whose sums run over
edge shards: one here, one per mesh device and rank in
``parallel/distributed.py``.

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


@dataclass
class EdgeShard:
    """Edges on one device: indices i64 (``is_loop`` i32), relative poses
    and information f64, and the Schur pairs of the shard's own edges."""

    device: torch.device
    map_idx: torch.Tensor
    scan_idx: torch.Tensor
    is_loop: torch.Tensor
    rel: torch.Tensor
    info: torch.Tensor
    pair_e1: torch.Tensor
    pair_e2: torch.Tensor

    @classmethod
    def upload(cls, device, map_idx, scan_idx, is_loop, rel, info):
        """The shard of these edges (NumPy arrays, rel and info taken as
        f32, as the JAX package takes them) on ``device``."""
        p1, p2 = schur_pairs(scan_idx)
        return cls(
            device,
            to_device(map_idx, device, np.int64),
            to_device(scan_idx, device, np.int64),
            to_device(is_loop, device, np.int32),
            to_device(rel, device, np.float32).to(torch.float64),
            to_device(info, device, np.float32).to(torch.float64),
            to_device(p1, device, np.int64),
            to_device(p2, device, np.int64),
        )


def _shard_sum(parts, shapes, home, reduce):
    """The sum of per-shard partials (a tuple of f64 tensors per shard, in
    shard order) on ``home``: a lone shard's partials as they are, several
    added in shard order, none zeros of ``shapes``; then ``reduce`` (the
    sum over ranks, ``parallel/distributed.py:RankSum.sum``) if given."""
    if parts:
        out = [p.to(home) for p in parts[0]]
        for part in parts[1:]:
            out = [o + p.to(home) for o, p in zip(out, part)]
    else:
        out = [torch.zeros(s, dtype=torch.float64, device=home) for s in shapes]
    return reduce(out) if reduce is not None else out


def schur_step(n_maps, n_scans, mp, sp, shards, lam, loss, reduce=None):
    """One Schur-complement LM step: eliminate the scan nodes (each edge
    touches exactly one), solve the reduced map-node system, back-substitute.
    Each shard forms its partial system on its device; the partials are
    summed (:func:`_shard_sum`) where the JAX package's distributed step
    has its five ``psum``s, so the edges of one scan node must share a
    shard.  A shard's Schur pairs give its fill-in.  Returns (dpm, dps) on
    ``mp``'s device."""
    home, dt = mp.device, mp.dtype
    blocks = [
        _edge_blocks(mp.to(s.device), sp.to(s.device), s.map_idx, s.scan_idx,
                     s.rel, s.info, s.is_loop, loss)
        for s in shards
    ]
    # psum 1 and 2: the per-scan diagonal blocks and right-hand sides
    Hee_n, be_n = _shard_sum(
        [(_segment_sum(Hee, s.scan_idx, n_scans),
          _segment_sum(be, s.scan_idx, n_scans))
         for s, (_, Hee, _, _, be) in zip(shards, blocks)],
        [(n_scans, 3, 3), (n_scans, 3)], home, reduce)
    Hee_n = Hee_n + lam * torch.eye(3, dtype=dt, device=home)
    Hee_inv = devmath.inv(Hee_n)

    # psum 3 and 4: the reduced right-hand side and matrix
    nv = 3 * n_maps
    parts = []
    for s, (Hss, _, Hse, bs, _) in zip(shards, blocks):
        W = Hse @ Hee_inv.to(s.device)[s.scan_idx]
        bm_red = _segment_sum(bs, s.map_idx, n_maps) - _segment_sum(
            (W @ be_n.to(s.device)[s.scan_idx][:, :, None])[:, :, 0],
            s.map_idx, n_maps)
        Hm = torch.zeros((nv, nv), dtype=dt, device=s.device)
        Hm.index_put_(_block_index(s.map_idx, s.map_idx), Hss,
                      accumulate=True)
        fill = -(W[s.pair_e1] @ Hse[s.pair_e2].transpose(1, 2))
        Hm.index_put_(_block_index(s.map_idx[s.pair_e1],
                                   s.map_idx[s.pair_e2]), fill,
                      accumulate=True)
        parts.append((bm_red, Hm))
    bm_red, Hm = _shard_sum(parts, [(n_maps, 3), (nv, nv)], home, reduce)
    Hm = Hm + lam * torch.eye(nv, dtype=dt, device=home)
    Hm, bm_flat = _fix_gauge(Hm, bm_red.reshape(-1))
    dpm = _solve_pos(Hm, bm_flat).reshape(n_maps, 3)

    # psum 5: dps_j = Hee_j^-1 (be_j - sum_{e: scan_e = j} Hse_e^T dpm(map_e))
    (cross,) = _shard_sum(
        [(_segment_sum(
            (Hse.transpose(1, 2) @ dpm.to(s.device)[s.map_idx][:, :, None])
            [:, :, 0], s.scan_idx, n_scans),)
         for s, (_, _, Hse, _, _) in zip(shards, blocks)],
        [(n_scans, 3)], home, reduce)
    dps = (Hee_inv @ (be_n - cross)[:, :, None])[:, :, 0]
    return dpm, dps


def optimize_core(cfg: OptimizerConfig, n_maps, n_scans, map_poses,
                  scan_poses, shards, lam0, reduce=None):
    """Port of ``_optimize_core``: ``num_iterations_max`` masked LM steps
    in f64 over the edge ``shards``, the dense solve (one shard) or
    :func:`schur_step`, every sum over shards then ranks (``reduce``).
    Returns (map poses, scan poses, error, lambda, iterations, initial
    error) as device tensors, the poses and errors rounded to f32."""
    loss = cfg.loss
    dev = map_poses.device
    mp, sp = map_poses.to(torch.float64), scan_poses.to(torch.float64)

    def total(mp, sp):
        # The f32 error, as the JAX package compares it: rounding the f64
        # sum also removes its device-dependent last bits, so accept and
        # stop decide the same on every device.
        (err,) = _shard_sum(
            [(_total_error(mp.to(s.device), sp.to(s.device), s.map_idx,
                           s.scan_idx, s.rel, s.info, loss),)
             for s in shards], [()], dev, reduce)
        return err.to(torch.float32)

    def step(mp, sp, lam):
        if cfg.solver == "dense":
            (s,) = shards
            return _solve_dense(n_maps, n_scans, *_edge_blocks(
                mp, sp, s.map_idx, s.scan_idx, s.rel, s.info, s.is_loop,
                loss), s.map_idx, s.scan_idx, lam)
        return schur_step(n_maps, n_scans, mp, sp, shards, lam, loss, reduce)

    err = total(mp, sp)
    init_err = err
    lam = torch.full((), lam0, dtype=torch.float64, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(cfg.num_iterations_max):
        dpm, dps = step(mp, sp, lam)
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
    """Host wrapper: clips edge information, puts the edges on the device
    as one shard, and keeps the persistent lambda (the reference keeps
    ``mLambda`` across Optimize() calls).  The distributed LM
    (``parallel/distributed.py``) changes only the shards, the sum over
    ranks, the clip and the metric series."""

    # The reference's series (pose_graph_optimizer_lm.cpp:17-35)
    SERIES = ("NumOfIterations", "InitialError", "FinalError",
              "NumOfLocalMapNodes", "NumOfScanNodes", "NumOfEdges")

    def __init__(self, cfg: OptimizerConfig = OptimizerConfig(), *, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.info_clip = cfg.info_clip
        self.reduce = None
        self.lam = cfg.initial_lambda
        vs = MetricManager.instance().value_sequence
        self._m = {n: vs("PoseGraphOptimizerLM." + n) for n in self.SERIES}

    def _shards(self, map_idx, scan_idx, is_loop, rel, info):
        """The edges this process evaluates, as shards on their devices."""
        return [EdgeShard.upload(self.device, map_idx, scan_idx, is_loop,
                                 rel, info)]

    def optimize(self, map_poses, scan_poses, edges):
        """edges = (map_idx, scan_idx, is_loop, rel, info) as NumPy arrays.
        Returns (map_poses, scan_poses, stats dict)."""
        map_idx, scan_idx, is_loop, rel, info = (np.asarray(a) for a in edges)
        M, N, E = len(map_poses), len(scan_poses), len(map_idx)
        if E == 0:
            return map_poses, scan_poses, dict(iterations=0, error=0.0)
        span = MetricManager.instance().span
        with span("graph.prepare"):
            info = np.array(info, np.float32)
            # Clip the information's spectral norm (see cfg.info_clip)
            norms = np.linalg.norm(info, ord=2, axis=(1, 2))
            big = norms > self.info_clip
            if big.any():
                info[big] *= (self.info_clip / norms[big])[:, None, None]
            dev = self.device
            mp0 = to_device(map_poses, dev, np.float32)
            sp0 = to_device(scan_poses, dev, np.float32)
            shards = self._shards(map_idx, scan_idx, is_loop, rel, info)
        with span("graph.solve"):
            out = optimize_core(self.cfg, M, N, mp0, sp0, shards,
                                float(np.float32(self.lam)), self.reduce)
        mp, sp, err, lam, iters, init_err = fetch(out)
        self.lam = float(lam)
        stats = dict(iterations=int(iters), error=float(err),
                     initial_error=float(init_err))
        observed = dict(NumOfIterations=stats["iterations"],
                        InitialError=stats["initial_error"],
                        FinalError=stats["error"], NumOfLocalMapNodes=M,
                        NumOfScanNodes=N, NumOfEdges=E)
        for name, series in self._m.items():
            series.observe(observed[name])
        return mp, sp, stats
