"""f32 math that gives the same bits on the CPU and on CUDA.

CUDA's and the CPU's f32 transcendental functions differ in the last ulp
for a few percent of arguments, and their matmul and sum kernels add in
different orders.  SLAM amplifies such differences: a pose that moves by
1e-7 m moves a few ray samples into the next map cell, the map changes,
the next match moves by 1e-5 m, and some keyframes later a scan-matching
argmax or a loop candidate flips (measured on the H100: a CUDA run and a
CPU run of the same sequence drifted 7 cm apart and closed different
loops).  Elementwise + - * / and floor are IEEE on both devices, so only
these ops need care: each is computed in f64 and rounded to f32 once.  The
f64 result is within an f64 ulp or two of exact on either device, so the
rounded f32 values agree everywhere except within ~1e-16 of a rounding
boundary.

Every function returns its first argument's dtype.  Given f64 tensors it
is the plain f64 op: the pose-graph LM (``graph/optimizer.py``) runs
whole in f64 on these functions and rounds its results to f32 once at the
end, which is the same rule over a longer computation.
"""
from __future__ import annotations

import torch


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.to(torch.float64)).to(x.dtype)


def cos(x: torch.Tensor) -> torch.Tensor:
    return _f64(torch.cos, x)


def sin(x: torch.Tensor) -> torch.Tensor:
    return _f64(torch.sin, x)


def asin(x: torch.Tensor) -> torch.Tensor:
    return _f64(torch.asin, x)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(y.to(torch.float64), x.to(torch.float64)).to(y.dtype)


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 b`` without a host sync: a singular system gives non-finite
    values rather than an error."""
    return torch.linalg.solve_ex(a.to(torch.float64),
                                 b.to(torch.float64)).result.to(a.dtype)


def inv(a: torch.Tensor) -> torch.Tensor:
    """``a^-1`` (batched) without a host sync, as :func:`solve`."""
    return torch.linalg.inv_ex(a.to(torch.float64)).inverse.to(a.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f64, rounded to ``a``'s dtype."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(a.dtype)


def sum(x: torch.Tensor, dim: int) -> torch.Tensor:  # noqa: A001 - mirrors torch.sum
    """Sum along ``dim`` accumulated in f64, rounded to ``x``'s dtype."""
    return x.to(torch.float64).sum(dim=dim).to(x.dtype)
