"""Launch wrappers of the hand-written CUDA CSM sweeps, the counterparts
of ``ops/csm_pallas.py:sweep``: :func:`csm_sweep` for u8 windows
(``csrc/csm_sweep.cu``) and :func:`csm_sweep_f32` for f32 windows
(``csrc/csm_sweep_f32.cu``).

Each kernel is compiled with ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``: one shared library per source, cached under
``build/kernels/`` by a hash of the source) and bound with ``ctypes``.
Nothing is built or loaded when this module is imported.

``LAUNCHES`` counts the u8 kernel's launches and ``F32_LAUNCHES`` the f32
kernel's; each is incremented only here, right after a launch that the
runtime accepted.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, quant

NAME = "csm_sweep"
NAME_F32 = "csm_sweep_f32"

LAUNCHES = 0
F32_LAUNCHES = 0
_libs = {}


def _load(name):
    if name not in _libs:
        lib = ctypes.CDLL(str(cuda_build.build(name)[name]["path"]))
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + ([ctypes.c_float] if name == NAME else []) + [ctypes.c_void_p]
        )
        launch.restype = ctypes.c_int
        max_beams = getattr(lib, f"{name}_max_beams")
        max_beams.argtypes = []
        max_beams.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def check_sweep_args(win, hr, hc, ok, origins, tile_h, tile_w, stride):
    """Raise on any input the sweep (kernel or plain) does not take:
    win u8 or f32 ``[N, in_r, in_c, 2]`` (channels interleaved); hr, hc
    i32 and ok bool ``[N, T, B]``; tile origins i32 ``[N, K, 2]``; tile
    height, width and stride positive; all on one device."""
    if (win.dtype not in (torch.uint8, torch.float32) or win.ndim != 4
            or win.shape[3] != 2):
        raise ValueError(
            f"win must be u8 or f32 [N, in_r, in_c, 2], got {win.dtype} "
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


def _launch(name, win, hr, hc, ok, origins, tile_h, tile_w, stride, *extra):
    """Check, allocate the output and launch ``name``'s kernel; returns
    the output."""
    check_sweep_args(win, hr, hc, ok, origins, tile_h, tile_w, stride)
    tensors = (win, hr, hc, ok, origins)
    if any(a.device.type != "cuda" for a in tensors):
        raise ValueError(f"{name} launches on CUDA tensors only")
    if any(not a.is_contiguous() for a in tensors):
        raise ValueError(f"{name} takes contiguous tensors only")
    if win.data_ptr() % 16:
        raise ValueError(f"{name} reads the window in aligned words")
    lib = _load(name)
    N, in_r, in_c, _ = win.shape
    T, B = hr.shape[1], hr.shape[2]
    K = origins.shape[1]
    max_beams = getattr(lib, f"{name}_max_beams")()
    if B > max_beams:
        raise ValueError(f"{name} takes at most {max_beams} beams, got {B}")
    out = torch.empty((N, T, 2, K * tile_h * tile_w), dtype=torch.float32,
                      device=win.device)
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream(win.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            win.data_ptr(), hr.data_ptr(), hc.data_ptr(), ok.data_ptr(),
            origins.data_ptr(), out.data_ptr(), N, T, B, in_r, in_c, K,
            tile_h, tile_w, stride, *extra, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def csm_sweep(win, hr, hc, ok, origins, *, tile_h, tile_w, stride,
              scale=quant.INV255):
    """Launch the u8 sweep kernel: f32 ``[N, T, 2, K * tile_h * tile_w]``,
    offset ``(k * tile_h + j) * tile_w + i`` at ``origins[n, k] + (j, i) *
    stride``, the integer sums times ``scale``.

    Takes what :func:`check_sweep_args` takes with a u8 window, on a CUDA
    device and contiguous; raises on anything else.  Launches on the
    current stream and does not synchronize."""
    global LAUNCHES
    if win.dtype != torch.uint8:
        check_sweep_args(win, hr, hc, ok, origins, tile_h, tile_w, stride)
        raise ValueError(f"csm_sweep takes u8 windows, got {win.dtype}; "
                         "f32 windows go to csm_sweep_f32")
    out = _launch(NAME, win, hr, hc, ok, origins, tile_h, tile_w, stride,
                  float(scale))
    LAUNCHES += 1
    return out


def csm_sweep_f32(win, hr, hc, ok, origins, *, tile_h, tile_w, stride):
    """Launch the f32 sweep kernel: the offsets and output of
    :func:`csm_sweep`, the sums over an f32 window taken in f64 and
    rounded to f32 once (exact, ``csrc/csm_sweep_f32.cu``).

    Takes what :func:`check_sweep_args` takes with an f32 window, on a
    CUDA device and contiguous; raises on anything else.  Launches on the
    current stream and does not synchronize."""
    global F32_LAUNCHES
    if win.dtype != torch.float32:
        check_sweep_args(win, hr, hc, ok, origins, tile_h, tile_w, stride)
        raise ValueError(f"csm_sweep_f32 takes f32 windows, got {win.dtype}; "
                         "u8 windows go to csm_sweep")
    out = _launch(NAME_F32, win, hr, hc, ok, origins, tile_h, tile_w, stride)
    F32_LAUNCHES += 1
    return out
