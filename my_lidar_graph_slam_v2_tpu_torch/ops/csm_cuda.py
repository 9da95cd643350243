"""Launch wrappers of the hand-written CUDA CSM sweeps, the counterparts
of ``ops/csm_pallas.py:sweep``: :func:`csm_sweep` for u8 windows
(``csrc/csm_sweep.cu``) and :func:`csm_sweep_f32` for f32 windows
(``csrc/csm_sweep_f32.cu``).

Each kernel is compiled with ``nvcc`` for ``sm_90a`` on first use
(``ops/cuda_build.py``: one shared library per source, cached under
``build/kernels/`` by a hash of the source) and bound with ``ctypes``.
Nothing is built or loaded when this module is imported.

The f32 form is two kernels of one source: :func:`csm_pack_f32` packs
the window into one u64 per cell (exact fixed point), and the sweep adds
those integers.  ``LAUNCHES`` counts the u8 kernel's launches,
``F32_LAUNCHES`` the f32 sweep's and ``F32_PACK_LAUNCHES`` the pack's
(one each per :func:`csm_sweep_f32` call); each is incremented only here,
right after a launch that the runtime accepted.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, quant

NAME = "csm_sweep"
NAME_F32 = "csm_sweep_f32"

LAUNCHES = 0
F32_LAUNCHES = 0
F32_PACK_LAUNCHES = 0
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
        if name == NAME_F32:
            pack = lib.csm_sweep_f32_pack_launch
            pack.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_void_p]
            pack.restype = ctypes.c_int
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
    """Check, allocate the output and launch ``name``'s kernel (an f32
    window packed first, :func:`_pack`); returns the output."""
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
    data = win if name == NAME else _pack(lib, win)
    out = torch.empty((N, T, 2, K * tile_h * tile_w), dtype=torch.float32,
                      device=win.device)
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream(win.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(
            data.data_ptr(), hr.data_ptr(), hc.data_ptr(), ok.data_ptr(),
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


def _pack(lib, win):
    """Launch the pack kernel on a checked f32 window: i64 ``[N, in_r,
    in_c]``, one u64 cell each (:func:`csm_pack_f32`)."""
    global F32_PACK_LAUNCHES
    packed = torch.empty(win.shape[:3], dtype=torch.int64, device=win.device)
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream(win.device).cuda_stream
        rc = lib.csm_sweep_f32_pack_launch(win.data_ptr(), packed.data_ptr(),
                                           packed.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"csm_sweep_f32 pack launch failed: CUDA error {rc}")
    F32_PACK_LAUNCHES += 1
    return packed


def csm_pack_f32(win):
    """Launch the f32 sweep's pack kernel: i64 ``[N, in_r, in_c]``, each
    cell of the f32 window ``[N, in_r, in_c, 2]`` as one u64 ``m | obs <<
    56`` with ``m = prob * 2^41`` rounded to an integer (exact for a prob
    of 0 or in [2^-18, 1]) and ``obs = observed != 0``; the plain version
    is ``ops/csm.py:pack_f32_window_plain``.  Takes an f32 window on a
    CUDA device, contiguous and 16-byte aligned; raises on anything else.
    Launches on the current stream and does not synchronize."""
    if win.dtype != torch.float32 or win.ndim != 4 or win.shape[3] != 2:
        raise ValueError(f"csm_pack_f32 takes an f32 [N, in_r, in_c, 2] "
                         f"window, got {win.dtype} {tuple(win.shape)}")
    if win.device.type != "cuda":
        raise ValueError("csm_pack_f32 launches on CUDA tensors only")
    if not win.is_contiguous() or win.data_ptr() % 16:
        raise ValueError("csm_pack_f32 takes a contiguous, aligned window")
    return _pack(_load(NAME_F32), win)


def csm_sweep_f32(win, hr, hc, ok, origins, *, tile_h, tile_w, stride):
    """Launch the f32 sweep: the offsets and output of :func:`csm_sweep`,
    the sums over an f32 window exact and rounded to f32 once, as the
    plain version's f64 sums are (``csrc/csm_sweep_f32.cu``: the pack
    kernel, then the sweep kernel over its integer cells).

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
