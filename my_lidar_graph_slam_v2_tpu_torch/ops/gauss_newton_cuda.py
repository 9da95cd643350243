"""Launch wrapper of the hand-written CUDA Gauss-Newton refinement
(``csrc/gauss_newton.cu``): one match's initial cost, damped GN steps and
covariance in one launch, the CUDA side of ``ops/gauss_newton.py:refine``.

Built with ``nvcc`` for ``sm_90a`` on first use (``ops/cuda_build.py``)
and bound with ``ctypes``; nothing is built or loaded at import.

``LAUNCHES`` counts kernel launches, and each launch also adds one to the
registry counter ``GaussNewton.KernelRefines`` (host side, no sync); both
are incremented only here, right after a launch that the runtime accepted.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..metrics.registry import MetricManager
from . import cuda_build

NAME = "gauss_newton"
COUNTER = "GaussNewton.KernelRefines"

LAUNCHES = 0
_lib = None

# The kernel's output: f32 [16], iterations as i32 bits at _ITERS.
_OUT = 16
_ITERS = 4


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_build.build(NAME)[NAME]["path"]))
        lib.gauss_newton_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int]
            + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2
        )
        lib.gauss_newton_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _f32(x) -> float:
    """``x`` rounded to f32, as the plain version's f32 tensors and its
    f32 ops with a Python scalar round it."""
    return float(np.float32(x))


def check_refine_args(prob, observed, ranges, angles, mask, sensor_pose0,
                      offset_xy):
    """Raise on any input the kernel does not take: prob u8 or f32 ``[H,
    W]``, observed bool ``[H, W]``, ranges and angles f32 and mask bool
    ``[B]``, sensor_pose0 f32 ``[3]``, offset_xy f32 ``[2]``, all
    contiguous on one CUDA device."""
    if prob.dtype not in (torch.uint8, torch.float32) or prob.ndim != 2:
        raise ValueError(f"prob must be u8 or f32 [H, W], got {prob.dtype} "
                         f"{tuple(prob.shape)}")
    if observed.dtype != torch.bool or observed.shape != prob.shape:
        raise ValueError(f"observed must be bool {tuple(prob.shape)}, got "
                         f"{observed.dtype} {tuple(observed.shape)}")
    B = ranges.shape[0] if ranges.ndim == 1 else -1
    for name, a, dt, shape in (
            ("ranges", ranges, torch.float32, (B,)),
            ("angles", angles, torch.float32, (B,)),
            ("mask", mask, torch.bool, (B,)),
            ("sensor_pose0", sensor_pose0, torch.float32, (3,)),
            ("offset_xy", offset_xy, torch.float32, (2,))):
        if a.dtype != dt or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {dt} {list(shape)}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    tensors = (prob, observed, ranges, angles, mask, sensor_pose0, offset_xy)
    devs = {a.device for a in tensors}
    if len(devs) != 1 or prob.device.type != "cuda":
        raise ValueError(f"gauss_newton launches on one CUDA device, got "
                         f"{sorted(map(str, devs))}")
    if any(not a.is_contiguous() for a in tensors):
        raise ValueError("gauss_newton takes contiguous tensors only")


def refine(prob, observed, ranges, angles, mask, sensor_pose0, resolution,
           offset_xy, *, max_iterations, convergence_threshold,
           initial_lambda, covariance_scale):
    """Launch the kernel: ``(pose [3], cost, iterations (i32), cov [3, 3],
    initial cost)`` as views of one f32 device buffer, the bits of
    ``ops/gauss_newton.py:refine``'s plain version.

    Takes what :func:`check_refine_args` takes; raises on anything else.
    Launches on the current stream and does not synchronize."""
    global LAUNCHES
    check_refine_args(prob, observed, ranges, angles, mask, sensor_pose0,
                      offset_xy)
    lib = _load()
    out = torch.empty(_OUT, dtype=torch.float32, device=prob.device)
    with torch.cuda.device(prob.device):
        stream = torch.cuda.current_stream(prob.device).cuda_stream
        rc = lib.gauss_newton_launch(
            prob.data_ptr(), int(prob.dtype == torch.float32),
            observed.data_ptr(), prob.shape[0], prob.shape[1],
            ranges.data_ptr(), angles.data_ptr(), mask.data_ptr(),
            ranges.shape[0], sensor_pose0.data_ptr(), offset_xy.data_ptr(),
            _f32(resolution), _f32(1.0 / resolution), int(max_iterations),
            _f32(convergence_threshold), _f32(initial_lambda),
            _f32(covariance_scale), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gauss_newton launch failed: CUDA error {rc}")
    LAUNCHES += 1
    MetricManager.instance().counter(COUNTER).increment()
    return (out[0:3], out[3], out[_ITERS:_ITERS + 1].view(torch.int32)[0],
            out[5:14].view(3, 3), out[14])
