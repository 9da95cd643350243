"""Launch wrapper of the hand-written CUDA CSM sweep
(``csrc/csm_sweep.cu``), the counterpart of ``ops/csm_pallas.py``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``: one shared library per source, cached under
``build/kernels/`` by a hash of the source) and bound with ``ctypes``.
Nothing is built or loaded when this module is imported.

``LAUNCHES`` counts kernel launches; it is incremented only here, right
after a launch that the runtime accepted.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, quant

NAME = "csm_sweep"

LAUNCHES = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_build.build(NAME)[NAME]["path"]))
        lib.csm_sweep_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.csm_sweep_launch.restype = ctypes.c_int
        lib.csm_sweep_max_beams.argtypes = []
        lib.csm_sweep_max_beams.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_sweep_args(win, hr, hc, ok, origins, tile_h, tile_w, stride):
    """Raise on any input the sweep (kernel or plain) does not take:
    win u8 ``[N, in_r, in_c, 2]`` (channels interleaved); hr, hc i32 and
    ok bool ``[N, T, B]``; tile origins i32 ``[N, K, 2]``; tile height,
    width and stride positive; all on one device."""
    if win.dtype != torch.uint8 or win.ndim != 4 or win.shape[3] != 2:
        raise ValueError(
            f"win must be u8 [N, in_r, in_c, 2], got {win.dtype} "
            f"{tuple(win.shape)}"
        )
    N = win.shape[0]
    for name, a, dt in (("hr", hr, torch.int32), ("hc", hc, torch.int32),
                        ("ok", ok, torch.bool)):
        if a.dtype != dt or a.ndim != 3 or a.shape[0] != N:
            raise ValueError(
                f"{name} must be {dt} [N={N}, T, B], got {a.dtype} "
                f"{tuple(a.shape)}"
            )
    if not (hr.shape == hc.shape == ok.shape):
        raise ValueError(
            f"hr/hc/ok shapes differ: {tuple(hr.shape)} {tuple(hc.shape)} "
            f"{tuple(ok.shape)}"
        )
    if (origins.dtype != torch.int32 or origins.ndim != 3
            or origins.shape[0] != N or origins.shape[2] != 2
            or origins.shape[1] < 1):
        raise ValueError(
            f"origins must be i32 [N={N}, K, 2], got {origins.dtype} "
            f"{tuple(origins.shape)}"
        )
    for name, v in (("tile_h", tile_h), ("tile_w", tile_w),
                    ("stride", stride)):
        if not isinstance(v, int) or v < 1:
            raise ValueError(f"{name} must be a positive int, got {v!r}")
    devs = {a.device for a in (win, hr, hc, ok, origins)}
    if len(devs) != 1:
        raise ValueError(f"sweep inputs on several devices: {devs}")


def csm_sweep(win, hr, hc, ok, origins, *, tile_h, tile_w, stride,
              scale=quant.INV255):
    """Launch the sweep kernel: f32 ``[N, T, 2, K * tile_h * tile_w]``,
    offset ``(k * tile_h + j) * tile_w + i`` at ``origins[n, k] + (j, i) *
    stride``.

    Takes what :func:`check_sweep_args` takes, on a CUDA device and
    contiguous; raises on anything else.  Launches on the current stream
    and does not synchronize."""
    global LAUNCHES
    check_sweep_args(win, hr, hc, ok, origins, tile_h, tile_w, stride)
    tensors = (win, hr, hc, ok, origins)
    if any(a.device.type != "cuda" for a in tensors):
        raise ValueError("csm_sweep launches on CUDA tensors only")
    if any(not a.is_contiguous() for a in tensors):
        raise ValueError("csm_sweep takes contiguous tensors only")
    if win.data_ptr() % 16:
        raise ValueError("csm_sweep reads the window in aligned 16-byte words")
    lib = _load()
    N, in_r, in_c, _ = win.shape
    T, B = hr.shape[1], hr.shape[2]
    K = origins.shape[1]
    if B > lib.csm_sweep_max_beams():
        raise ValueError(
            f"csm_sweep takes at most {lib.csm_sweep_max_beams()} beams, "
            f"got {B}"
        )
    out = torch.empty((N, T, 2, K * tile_h * tile_w), dtype=torch.float32,
                      device=win.device)
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream(win.device).cuda_stream
        rc = lib.csm_sweep_launch(
            win.data_ptr(), hr.data_ptr(), hc.data_ptr(), ok.data_ptr(),
            origins.data_ptr(), out.data_ptr(), N, T, B, in_r, in_c, K,
            tile_h, tile_w, stride, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"csm_sweep launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
