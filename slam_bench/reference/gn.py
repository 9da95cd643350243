"""The square-error scan-to-map cost and its damped Gauss-Newton
minimiser (``cost_function_square_error.cpp``,
``scan_matcher_linear_solver.cpp``), in plain PyTorch at a chosen dtype.

Cost: the sum over a scan's beams of ``(1 - M(hit))^2``, with ``M`` the
bilinear interpolation of the u8 raster's probabilities at cell centres
(indices shifted by -0.5); an unknown or outside corner reads 0.5.  A step
solves ``(H + lambda I) dp = b`` and is taken only where it lowers the
cost; lambda halves on a taken step and quadruples on a refused one.
"""
from __future__ import annotations

import torch

INV255 = float(torch.tensor(1.0 / 255.0, dtype=torch.float32))


class Raster:
    """A u8 raster and its observed mask as the cost reads them."""

    def __init__(self, prob_u8, observed, offset_xy, resolution, dtype):
        self.p = (prob_u8.to(torch.float32) * INV255).to(dtype)
        self.obs = observed
        self.h, self.w = prob_u8.shape
        self.off = torch.as_tensor(offset_xy, dtype=dtype,
                                   device=prob_u8.device)
        self.res = resolution
        self.dtype = dtype

    def _read(self, r, c):
        inside = (r >= 0) & (r < self.h) & (c >= 0) & (c < self.w)
        idx = (r.clamp(0, self.h - 1) * self.w + c.clamp(0, self.w - 1))
        known = self.obs.reshape(-1)[idx] & inside
        return torch.where(known, self.p.reshape(-1)[idx],
                           torch.tensor(0.5, dtype=self.dtype,
                                        device=r.device))

    def eval(self, pose, ranges, angles, mask):
        """(H [3, 3], b [3], cost) at the sensor pose ``pose`` [3]."""
        ang = pose[2] + angles
        hx = pose[0] + ranges * torch.cos(ang)
        hy = pose[1] + ranges * torch.sin(ang)
        fcol = (hx - self.off[0]) / self.res - 0.5
        frow = (hy - self.off[1]) / self.res - 0.5
        r0, c0 = torch.floor(frow), torch.floor(fcol)
        dr, dc = frow - r0, fcol - c0
        rc0 = r0.long().clamp(min=0)
        cc0 = c0.long().clamp(min=0)
        rc1 = (rc0 + 1).clamp(max=self.h - 1)
        cc1 = (cc0 + 1).clamp(max=self.w - 1)
        m00, m01 = self._read(rc0, cc0), self._read(rc1, cc0)
        m10, m11 = self._read(rc0, cc1), self._read(rc1, cc1)
        value = dr * (dc * m11 + (1 - dc) * m01) + (1 - dr) * (
            dc * m10 + (1 - dc) * m00)
        gx = (dr * (m11 - m01) + (1 - dr) * (m10 - m00)) / self.res
        gy = (dc * (m11 - m10) + (1 - dc) * (m01 - m00)) / self.res
        gt = -(hy - pose[1]) * gx + (hx - pose[0]) * gy
        k = torch.stack([gx, gy, gt, 1 - value], -1) * mask[:, None]
        prod = k.to(torch.float64).T @ k.to(torch.float64)
        return prod[:3, :3], prod[:3, 3], prod[3, 3]


def refine(raster: Raster, pose0, ranges, angles, mask, iterations: int,
           convergence: float, lam0: float = 1e-4):
    """Sensor pose after at most ``iterations`` damped steps from
    ``pose0``, stopping after a taken step that lowers the cost by less
    than ``convergence``; every value held in the raster's dtype (the
    3 x 3 solve in f64)."""
    dt = raster.dtype
    p = torch.as_tensor(pose0, dtype=torch.float64).to(raster.p.device, dt)
    r = ranges.to(dt)
    a = angles.to(dt)
    mk = mask.to(dt)
    H, b, cur = raster.eval(p, r, a, mk)
    lam = lam0
    eye = torch.eye(3, dtype=torch.float64, device=p.device)
    for _ in range(iterations):
        step = torch.linalg.solve(H + lam * eye, b)
        if not bool(torch.isfinite(step).all()):
            break
        p_new = (p.to(torch.float64) + step).to(dt)
        H2, b2, c2 = raster.eval(p_new, r, a, mk)
        if c2 < cur:
            done = float(cur - c2) < convergence
            p, H, b, cur = p_new, H2, b2, c2
            lam = max(lam * 0.5, 1e-8)
            if done:
                break
        else:
            lam = min(lam * 4.0, 1e6)
    return p.to(torch.float64).cpu().numpy()
