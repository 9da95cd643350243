"""Launch wrapper of the hand-written CUDA CSM sweep
(``csrc/csm_sweep.cu``), the counterpart of ``ops/csm_pallas.py``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface on first use, cached under ``build/kernels/`` by
a hash of the source, and bound with ``ctypes``.  Nothing is built or
loaded when this module is imported.

``LAUNCHES`` counts kernel launches; it is incremented only here, right
after a launch that the runtime accepted.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import quant

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "csm_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = 0
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build() -> dict:
    """Compile the kernel library if this source has not been built yet.

    Returns ``{"path", "seconds", "log", "cached"}``; ``log`` holds
    nvcc's output, including ``-Xptxas -v``'s register and shared-memory
    report."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"csm_sweep_{tag}.so"
    if so.exists():
        return dict(path=so, seconds=0.0, log="", cached=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )
    os.replace(tmp, so)
    return dict(path=so, seconds=seconds, log=res.stdout + res.stderr,
                cached=False)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()["path"]))
        lib.csm_sweep_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.csm_sweep_launch.restype = ctypes.c_int
        lib.csm_sweep_max_beams.argtypes = []
        lib.csm_sweep_max_beams.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_sweep_args(win, hr, hc, ok, off):
    """Raise on any input the sweep (kernel or plain) does not take:
    win u8 ``[N, 2, in_r, in_c]``; hr, hc i32 and ok bool ``[N, T, B]``;
    off i32 ``[n_off, 2]``; all on one device."""
    if win.dtype != torch.uint8 or win.ndim != 4 or win.shape[1] != 2:
        raise ValueError(
            f"win must be u8 [N, 2, in_r, in_c], got {win.dtype} "
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
    if off.dtype != torch.int32 or off.ndim != 2 or off.shape[1] != 2:
        raise ValueError(
            f"off must be i32 [n_off, 2], got {off.dtype} {tuple(off.shape)}"
        )
    devs = {a.device for a in (win, hr, hc, ok, off)}
    if len(devs) != 1:
        raise ValueError(f"sweep inputs on several devices: {devs}")


def csm_sweep(win, hr, hc, ok, off, scale=quant.INV255):
    """Launch the sweep kernel: f32 ``[N, T, 2, n_off]``.

    Takes what :func:`check_sweep_args` takes, on a CUDA device and
    contiguous; raises on anything else.  Launches on the current stream
    and does not synchronize."""
    global LAUNCHES
    check_sweep_args(win, hr, hc, ok, off)
    tensors = (win, hr, hc, ok, off)
    if any(a.device.type != "cuda" for a in tensors):
        raise ValueError("csm_sweep launches on CUDA tensors only")
    if any(not a.is_contiguous() for a in tensors):
        raise ValueError("csm_sweep takes contiguous tensors only")
    lib = _load()
    N, _, in_r, in_c = win.shape
    T, B = hr.shape[1], hr.shape[2]
    n_off = off.shape[0]
    if B > lib.csm_sweep_max_beams():
        raise ValueError(
            f"csm_sweep takes at most {lib.csm_sweep_max_beams()} beams, "
            f"got {B}"
        )
    out = torch.empty((N, T, 2, n_off), dtype=torch.float32, device=win.device)
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream(win.device).cuda_stream
        rc = lib.csm_sweep_launch(
            win.data_ptr(), hr.data_ptr(), hc.data_ptr(), ok.data_ptr(),
            off.data_ptr(), out.data_ptr(), N, T, B, in_r, in_c, n_off,
            float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"csm_sweep launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
