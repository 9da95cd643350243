"""u8 probability-raster quantization.

Port of ``my_lidar_graph_slam_v2_tpu/ops/quant.py``: a cell stores
``round(p * 255)`` (round half to even, as ``jnp.round``); 0 keeps the
"unknown" convention of ``GridMapInterface::ProbabilityOr``.
"""
from __future__ import annotations

import numpy as np
import torch

INV255 = np.float32(1.0 / 255.0)


def quantize_prob(logodds: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
    """u8 probability raster straight from f32 log-odds."""
    p = torch.where(observed, torch.sigmoid(logodds), 0.0)
    return torch.round(p * 255.0).to(torch.uint8)


def quantize_prob_f32(prob: torch.Tensor) -> torch.Tensor:
    """u8 raster from an f32 probability raster (0 = unknown)."""
    return torch.round(prob * 255.0).to(torch.uint8)


def dequant_prob(prob: torch.Tensor) -> torch.Tensor:
    """f32 probabilities from either representation (a no-op for float
    inputs)."""
    if prob.dtype == torch.uint8:
        return prob.to(torch.float32) * float(INV255)
    return prob
