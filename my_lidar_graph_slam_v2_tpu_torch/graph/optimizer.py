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

Every shape is padded to the JAX package's power-of-two buckets
(:func:`pad_graph`), on every device, so a growing graph meets only
O(log E) shapes.  All ``num_iterations_max`` LM steps run masked, the
state frozen once the stop test fires, so the loop needs no host sync per
iteration: one fetch returns the result.  On a card the single-device LM
captures those steps once per bucket as a CUDA graph and replays it on
every later call (:class:`_Replay`): ~1,900 small kernels a call, which
the host would otherwise queue one by one.

The inputs arrive in f32, as in the JAX package.  The LM runs in f64 on
``utils/devmath.py``'s functions and rounds the poses and errors it
returns to f32 once, so the CPU and CUDA (LAPACK and cuSOLVER,
scatter-adds in any order) give the same poses.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from ..metrics.registry import MetricManager
from ..utils import devmath
from ..utils.capture import collector_paused
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


def _bucket(n: int, minimum: int = 16) -> int:
    """The JAX package's shape bucket: the least ``minimum * 2^k >= n``."""
    b = minimum
    while b < n:
        b *= 2
    return b


def clip_info(info, clip: float) -> np.ndarray:
    """Edge information as f32, each matrix scaled down to spectral norm
    ``clip`` where it is above (see ``OptimizerConfig.info_clip``)."""
    info = np.array(info, np.float32)
    norms = np.linalg.norm(info, ord=2, axis=(1, 2))
    big = norms > clip
    if big.any():
        info[big] *= (clip / norms[big])[:, None, None]
    return info


def pad_graph(map_poses, scan_poses, edges):
    """The JAX wrapper's padding: map and scan poses to ``Mb, Nb =
    _bucket(M), _bucket(N)`` rows of zeros, the edges (map_idx, scan_idx,
    is_loop, rel, info) to ``Eb = _bucket(E + 1)``, so at least one edge is
    padding.  A padded edge has zero rel, info and is_loop and points at
    the last padded node slot, or at node 0 where none is padded: it adds
    exact zeros to every sum.  Returns (map poses f32, scan poses f32,
    padded edges, ``real`` edge mask)."""
    map_idx, scan_idx, is_loop, rel, info = edges
    M, N, E = len(map_poses), len(scan_poses), len(map_idx)
    Mb, Nb, Eb = _bucket(M), _bucket(N), _bucket(E + 1)
    mp = np.zeros((Mb, 3), np.float32)
    mp[:M] = map_poses
    sp = np.zeros((Nb, 3), np.float32)
    sp[:N] = scan_poses
    mi = np.full(Eb, Mb - 1 if Mb > M else 0, np.int64)
    mi[:E] = map_idx
    si = np.full(Eb, Nb - 1 if Nb > N else 0, np.int64)
    si[:E] = scan_idx
    il = np.zeros(Eb, np.int32)
    il[:E] = is_loop
    rl = np.zeros((Eb, 3), np.float32)
    rl[:E] = rel
    im = np.zeros((Eb, 3, 3), np.float32)
    im[:E] = info
    return mp, sp, (mi, si, il, rl, im), np.arange(Eb) < E


def schur_pairs(scan_idx: np.ndarray, real=None):
    """Ordered pairs ``(a, b)`` of edges sharing a scan node, ``a == b``
    included: for each scan node of degree k, its k^2 pairs.  Vectorized
    (the JAX package enumerates them in a Python double loop).  With a
    ``real`` edge mask the pairs are those of the real edges, padded as
    the JAX wrapper pads them: to ``_bucket(P)`` pairs, the padded ones
    on the last padded edge, where there is one."""
    if real is not None:
        real = np.asarray(real, bool)
        keep = np.flatnonzero(real)
        a, b = schur_pairs(np.asarray(scan_idx)[keep])
        a, b = keep[a], keep[b]
        if real.all():
            return a, b
        pad = np.full(_bucket(len(a)) - len(a), np.flatnonzero(~real)[-1])
        return np.concatenate([a, pad]), np.concatenate([b, pad])
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
    def upload(cls, device, map_idx, scan_idx, is_loop, rel, info,
               real=None):
        """The shard of these edges (NumPy arrays, rel and info taken as
        f32, as the JAX package takes them) on ``device``; ``real`` masks
        the padding's edges out of the Schur pairs (:func:`schur_pairs`)."""
        p1, p2 = schur_pairs(scan_idx, real)
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
    :func:`schur_step`, every sum over shards then ranks (``reduce``),
    from lambda ``lam0`` (a 0-d f64 device tensor, so a captured graph
    reads it rather than baking it in).  Returns (map poses, scan poses,
    error, lambda, iterations, initial error) as device tensors, the poses
    and errors rounded to f32.  No operation syncs the host."""
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
    lam = lam0
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


class _Replay:
    """:func:`optimize_core` of one shape bucket on one shard, captured as
    a CUDA graph: the tensors it reads (its first call's inputs, kept) and
    writes.  A call copies its inputs into them and replays."""

    # The shard's tensors, in its field order
    SHARD = tuple(f.name for f in fields(EdgeShard) if f.name != "device")

    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs

    @classmethod
    def _tensors(cls, map_poses, scan_poses, shard, lam0):
        return (map_poses, scan_poses, lam0) + tuple(
            getattr(shard, f) for f in cls.SHARD)

    @classmethod
    def capture(cls, cfg, n_maps, n_scans, map_poses, scan_poses, shard,
                lam0):
        """Warm up on a side stream: one LM step, which runs each of the
        steps' kernels once at these shapes and makes that stream's cuBLAS
        and cuSOLVER workspaces, as capture requires.  Then capture all
        the steps there, in thread-local mode, so that another thread's
        CUDA calls cannot break the capture, with the garbage collector
        paused."""
        dev = map_poses.device
        here = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            run = (n_maps, n_scans, map_poses, scan_poses, [shard], lam0)
            optimize_core(replace(cfg, num_iterations_max=1), *run)
            graph = torch.cuda.CUDAGraph()
            with collector_paused():
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = optimize_core(cfg, *run)
                finally:
                    graph.capture_end()
        here.wait_stream(side)
        return cls(graph, cls._tensors(map_poses, scan_poses, shard, lam0),
                   outputs)

    def __call__(self, map_poses, scan_poses, shard, lam0):
        for dst, src in zip(self.inputs, self._tensors(map_poses, scan_poses,
                                                       shard, lam0)):
            dst.copy_(src)
        self.graph.replay()
        return self.outputs


class PoseGraphOptimizer:
    """Host wrapper: clips edge information, pads the graph to the JAX
    package's buckets (:func:`pad_graph`), puts the edges on the device as
    one shard, and keeps the persistent lambda (the reference keeps
    ``mLambda`` across Optimize() calls).  On a card it replays one
    captured CUDA graph per bucket (:meth:`_solve`).  The distributed LM
    (``parallel/distributed.py``) changes only the shards, the sum over
    ranks, the clip and the metric series, and runs eagerly."""

    # The reference's series (pose_graph_optimizer_lm.cpp:17-35)
    SERIES = ("NumOfIterations", "InitialError", "FinalError",
              "NumOfLocalMapNodes", "NumOfScanNodes", "NumOfEdges")
    # Captured buckets kept: the graph only grows, so an older bucket is
    # not met again
    GRAPHS_KEPT = 4

    def __init__(self, cfg: OptimizerConfig = OptimizerConfig(), *, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.info_clip = cfg.info_clip
        self.reduce = None
        self.lam = cfg.initial_lambda
        self._graphs = collections.OrderedDict()
        vs = MetricManager.instance().value_sequence
        self._m = {n: vs("PoseGraphOptimizerLM." + n) for n in self.SERIES}

    def _shards(self, map_idx, scan_idx, is_loop, rel, info, real):
        """The edges this process evaluates, as shards on their devices."""
        return [EdgeShard.upload(self.device, map_idx, scan_idx, is_loop,
                                 rel, info, real)]

    def _replays(self, shards) -> bool:
        """Whether this call runs as a CUDA graph: on a card, one shard
        and no sum over ranks, the single-device LM."""
        return (self.device.type == "cuda" and len(shards) == 1
                and self.reduce is None)

    def _solve(self, n_maps, n_scans, map_poses, scan_poses, shards, lam0):
        """:func:`optimize_core`'s outputs: eager, or the replay of the
        bucket's CUDA graph, captured on the bucket's first call.  The
        registry counts the captures (``PoseGraphOptimizerLM.GraphCaptures``)
        and the calls that replay a graph captured by an earlier call
        (``GraphReplays``)."""
        args = (n_maps, n_scans, map_poses, scan_poses)
        if not self._replays(shards):
            return optimize_core(self.cfg, *args, shards, lam0, self.reduce)
        (shard,) = shards
        key = (self.cfg.solver, n_maps, n_scans, len(shard.map_idx),
               len(shard.pair_e1))
        mm = MetricManager.instance()
        replay = self._graphs.pop(key, None)
        if replay is None:
            with mm.span("graph.capture"):
                replay = _Replay.capture(self.cfg, *args, shard, lam0)
            mm.counter("PoseGraphOptimizerLM.GraphCaptures").increment()
        else:
            mm.counter("PoseGraphOptimizerLM.GraphReplays").increment()
        self._graphs[key] = replay
        while len(self._graphs) > self.GRAPHS_KEPT:
            self._graphs.popitem(last=False)
        return replay(map_poses, scan_poses, shard, lam0)

    def optimize(self, map_poses, scan_poses, edges):
        """edges = (map_idx, scan_idx, is_loop, rel, info) as NumPy arrays.
        Returns (map_poses, scan_poses, stats dict)."""
        map_idx, scan_idx, is_loop, rel, info = (np.asarray(a) for a in edges)
        M, N, E = len(map_poses), len(scan_poses), len(map_idx)
        if E == 0:
            return map_poses, scan_poses, dict(iterations=0, error=0.0)
        span = MetricManager.instance().span
        with span("graph.prepare"):
            info = clip_info(info, self.info_clip)
            mp, sp, padded, real = pad_graph(
                map_poses, scan_poses, (map_idx, scan_idx, is_loop, rel, info))
            dev = self.device
            mp0 = to_device(mp, dev)
            sp0 = to_device(sp, dev)
            lam0 = torch.full((), float(np.float32(self.lam)),
                              dtype=torch.float64, device=dev)
            shards = self._shards(*padded, real)
        with span("graph.solve"):
            out = self._solve(len(mp), len(sp), mp0, sp0, shards, lam0)
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
        return mp[:M], sp[:N], stats
