"""Pose-graph Levenberg-Marquardt (``pose_graph_optimizer_lm.cpp``) in
plain PyTorch, dense, at a chosen dtype.

The graph is bipartite: local-map nodes and scan nodes; an edge's error is
the scan node's pose in the map node's frame minus the measured relative
pose, its angle wrapped.  Loop edges get robust IRLS weights; the robust
loss applies to every edge in the total error, which is compared after
rounding to float32.  The first map node is held fixed.  Lambda halves on
an accepted step, doubles on a refused one, and is carried from one call
to the next.  Information matrices are taken in float32 with their
spectral norm clipped to ``info_clip``.
"""
from __future__ import annotations

import numpy as np
import torch


def huber_loss(t, s):
    return torch.where(t <= s, t, 2.0 * torch.sqrt(s * t) - s)


def huber_weight(t, s):
    return torch.where(t <= s, torch.ones_like(t),
                       torch.sqrt(s / torch.clamp(t, min=1e-300)))


def clip_information(info, clip):
    info = np.array(info, np.float32)
    norms = np.linalg.norm(info, ord=2, axis=(1, 2))
    big = norms > clip
    if big.any():
        info[big] *= (clip / norms[big])[:, None, None]
    return info


class Graph:
    """One call's edges on ``device`` in ``dtype``."""

    def __init__(self, edges, clip, device, dtype):
        map_idx, scan_idx, is_loop, rel, info = (np.asarray(a) for a in edges)
        self.mi = torch.as_tensor(map_idx, dtype=torch.long, device=device)
        self.si = torch.as_tensor(scan_idx, dtype=torch.long, device=device)
        self.loop = torch.as_tensor(is_loop, device=device) > 0
        self.rel = torch.as_tensor(np.asarray(rel, np.float32),
                                   device=device).to(dtype)
        self.info = torch.as_tensor(clip_information(info, clip),
                                    device=device).to(dtype)

    def errors(self, mp, sp):
        a, e = mp[self.mi], sp[self.si]
        st, ct = torch.sin(a[:, 2]), torch.cos(a[:, 2])
        d = e - a
        x = ct * d[:, 0] + st * d[:, 1]
        y = -st * d[:, 0] + ct * d[:, 1]
        et = d[:, 2] - self.rel[:, 2]
        et = torch.atan2(torch.sin(et), torch.cos(et))
        err = torch.stack([x - self.rel[:, 0], y - self.rel[:, 1], et], -1)
        return err, st, ct, x, y

    def chi2(self, err):
        return torch.einsum("ei,eij,ej->e", err, self.info, err)

    def total(self, mp, sp, scale):
        err = self.errors(mp, sp)[0]
        return huber_loss(self.chi2(err), scale).sum().to(torch.float32)

    def step(self, mp, sp, lam, scale):
        """The damped normal equations' solution (dmp, dsp), NaN where the
        Cholesky factorisation fails."""
        err, st, ct, x, y = self.errors(mp, sp)
        w = torch.where(self.loop, huber_weight(self.chi2(err), scale), 1.0)
        z, o = torch.zeros_like(ct), torch.ones_like(ct)
        js = torch.stack([torch.stack([-ct, -st, y], -1),
                          torch.stack([st, -ct, -x], -1),
                          torch.stack([z, z, -o], -1)], -2)
        je = torch.stack([torch.stack([ct, st, z], -1),
                          torch.stack([-st, ct, z], -1),
                          torch.stack([z, z, o], -1)], -2)
        nm, ns = mp.shape[0], sp.shape[0]
        n = 3 * (nm + ns)
        cols = [self.mi, nm + self.si]
        jac = [js, je]
        winfo = self.info * w[:, None, None]
        H = torch.zeros((n, n), dtype=mp.dtype, device=mp.device)
        b = torch.zeros(n, dtype=mp.dtype, device=mp.device)
        k = torch.arange(3, device=mp.device)
        for ia in range(2):
            ra = (cols[ia][:, None] * 3 + k)
            jt_i = jac[ia].transpose(1, 2) @ winfo
            b.index_put_((ra,), -(jt_i @ err[:, :, None])[:, :, 0],
                         accumulate=True)
            for ib in range(2):
                rb = (cols[ib][:, None] * 3 + k)
                H.index_put_((ra[:, :, None].expand(-1, 3, 3),
                              rb[:, None, :].expand(-1, 3, 3)),
                             jt_i @ jac[ib], accumulate=True)
        H = H + lam * torch.eye(n, dtype=mp.dtype, device=mp.device)
        keep = torch.arange(n, device=mp.device) >= 3
        H = torch.where(keep[:, None] & keep[None, :], H, 0.0)
        H = H + torch.diag((~keep).to(H.dtype))
        b = torch.where(keep, b, 0.0)
        L, info = torch.linalg.cholesky_ex(H)
        dp = torch.cholesky_solve(b[:, None], L)[:, 0]
        if int(info) != 0:
            dp = torch.full_like(dp, float("nan"))
        return dp[:3 * nm].reshape(nm, 3), dp[3 * nm:].reshape(ns, 3)


def optimize(cfg: dict, map_poses, scan_poses, edges, lam0: float, device,
             dtype=torch.float64):
    """One call: (map poses, scan poses) as f64 NumPy arrays and the lambda
    the next call starts from."""
    if len(np.asarray(edges[0])) == 0:
        return np.asarray(map_poses), np.asarray(scan_poses), lam0
    g = Graph(edges, cfg["info_clip"], device, dtype)
    scale = cfg["huber_scale"]
    mp = torch.as_tensor(np.asarray(map_poses, np.float32), device=device
                         ).to(dtype)
    sp = torch.as_tensor(np.asarray(scan_poses, np.float32), device=device
                         ).to(dtype)
    err = g.total(mp, sp, scale)
    lam = float(np.float32(lam0))
    for it in range(1, cfg["iterations"] + 1):
        dmp, dsp = g.step(mp, sp, lam, scale)
        mp2, sp2 = mp + dmp, sp + dsp
        err2 = g.total(mp2, sp2, scale)
        good = bool(err2 < err)
        lam2 = lam * 0.5 if good else lam * 2.0
        stop = (it >= cfg["iterations"]
                or (good and float(err - err2) < cfg["error_tolerance"])
                or lam2 > 1e12)
        if good:
            mp, sp, err = mp2, sp2, err2
        lam = lam2
        if stop:
            break
    return (mp.to(torch.float32).double().cpu().numpy(),
            sp.to(torch.float32).double().cpu().numpy(), lam)
