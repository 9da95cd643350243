"""Launch wrapper of the hand-written CUDA hit-image build
(``csrc/hit_images.cu``), the counterpart of
``ops/csm_pallas.py:build_hit_images``.

Built with ``nvcc`` for ``sm_90a`` on first use (``ops/cuda_build.py``)
and bound with ``ctypes``; nothing is built or loaded at import.

``LAUNCHES`` counts kernel launches; it is incremented only here, right
after a launch that the runtime accepted.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

NAME = "hit_images"

LAUNCHES = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_build.build(NAME)[NAME]["path"]))
        lib.hit_images_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.hit_images_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_hit_args(rows, cols, crop_rows, crop_cols):
    """Raise on any input the build (kernel or plain) does not take: rows
    and cols i32 ``[T, B]`` of one shape on one device, positive crop."""
    for name, a in (("rows", rows), ("cols", cols)):
        if a.dtype != torch.int32 or a.ndim != 2:
            raise ValueError(
                f"{name} must be i32 [T, B], got {a.dtype} {tuple(a.shape)}"
            )
    if rows.shape != cols.shape:
        raise ValueError(
            f"rows/cols shapes differ: {tuple(rows.shape)} {tuple(cols.shape)}"
        )
    if rows.device != cols.device:
        raise ValueError(
            f"rows/cols on several devices: {rows.device} {cols.device}"
        )
    if int(crop_rows) < 1 or int(crop_cols) < 1:
        raise ValueError(f"crop must be positive, got {crop_rows}x{crop_cols}")


def hit_images(rows, cols, *, crop_rows, crop_cols):
    """Launch the kernel: f32 ``[T, crop_rows, crop_cols]`` hit counts.

    Takes what :func:`check_hit_args` takes, on a CUDA device and
    contiguous; raises on anything else.  Launches on the current stream
    and does not synchronize."""
    global LAUNCHES
    check_hit_args(rows, cols, crop_rows, crop_cols)
    if rows.device.type != "cuda":
        raise ValueError("hit_images launches on CUDA tensors only")
    if not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("hit_images takes contiguous tensors only")
    lib = _load()
    T, B = rows.shape
    out = torch.empty((T, crop_rows, crop_cols), dtype=torch.float32,
                      device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = lib.hit_images_launch(
            rows.data_ptr(), cols.data_ptr(), out.data_ptr(), T, B,
            int(crop_rows), int(crop_cols), stream,
        )
    if rc != 0:
        raise RuntimeError(f"hit_images launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
