"""Robust M-estimator kernels.

Port of ``my_lidar_graph_slam_v2_tpu/graph/loss.py``
(``mapping/robust_loss_function.{hpp,cpp}``): each kernel maps a squared
error ``t = e^T Lambda e`` to a loss rho(t) and an IRLS weight rho'(t), on
tensors of any shape and float dtype.  The default for pose-graph
optimization is Huber with scale 0.01.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LossFunction:
    kind: str = "Huber"
    scale: float = 0.01

    def loss(self, t: torch.Tensor) -> torch.Tensor:
        s = self.scale
        k = self.kind
        if k == "Squared":
            return t
        if k == "Huber":
            return torch.where(t <= s, t, 2.0 * torch.sqrt(s * t) - s)
        if k == "Cauchy":
            return s * torch.log1p(t / s)
        if k == "Fair":
            r = torch.sqrt(t / s)
            return 2.0 * s * (r - torch.log1p(r))
        if k in ("GemanMcClure", "DCS"):
            return s * t / (s + t)
        if k == "Welsch":
            return s * -torch.expm1(-t / s)
        raise ValueError(f"unknown loss kind {k}")

    def weight(self, t: torch.Tensor) -> torch.Tensor:
        s = self.scale
        k = self.kind
        if k == "Squared":
            return torch.ones_like(t)
        if k == "Huber":
            # 1e-300 is 0 in f32, as in the JAX package: the branch that
            # reads it is only taken for t > s.
            return torch.where(
                t <= s, 1.0, torch.sqrt(s / torch.clamp(t, min=1e-300))
            )
        if k == "Cauchy":
            return s / (s + t)
        if k == "Fair":
            return 1.0 / (1.0 + torch.sqrt(t / s))
        if k == "GemanMcClure":
            return (s / (s + t)) ** 2
        if k == "Welsch":
            return torch.exp(-t / s)
        if k == "DCS":
            return torch.where(t <= s, 1.0, (2.0 * s / (s + t)) ** 2)
        raise ValueError(f"unknown loss kind {k}")


LOSS_KINDS = (
    "Squared",
    "Huber",
    "Cauchy",
    "Fair",
    "GemanMcClure",
    "Welsch",
    "DCS",
)
