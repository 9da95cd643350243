"""The native (C++) pieces, loaded with ctypes: the Carmen log parser and
the CPU correlative-matching baseline of the CSM benchmark.

``carmen_reader.cpp`` and ``csm_baseline.cpp`` are the JAX package's
sources, copied unchanged.  Each is compiled with ``g++`` at first use
into ``build/native/`` at the root of the checkout, under a name that
carries a hash of the source and the flags, and never next to the
sources.  The parser is built without ``-march=native``, so one build
serves any host.  The baseline is built as the JAX package builds it,
with ``-march=native``, because the pinned rate it is compared with
(``BASELINE_CPU.json``) was measured on such a build; its name then also
carries a hash of this host's CPU flags, so a build directory copied to
another machine is never loaded there.  Nothing is built when this
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# The JAX loader's flags (my_lidar_graph_slam_v2_tpu/native/__init__.py).
BASELINE_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _cpu_flags() -> bytes:
    """This host's CPU feature flags, which ``-march=native`` builds for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def library_path(name: str, flags=CXX_FLAGS) -> Path:
    """Where the library of ``<name>.cpp`` built with ``flags`` is cached."""
    key = (SRC_DIR / f"{name}.cpp").read_bytes() + " ".join(flags).encode()
    if "-march=native" in flags:
        key += _cpu_flags()
    tag = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(name: str, flags=CXX_FLAGS) -> Path:
    """Compile ``<name>.cpp`` with ``flags`` unless it is built already;
    raises if there is no ``g++`` or the compile fails."""
    lib = library_path(name, flags)
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        hint = ("; read the log with native=False or None (the Python "
                "reader)" if name == "carmen_reader" else "")
        raise RuntimeError(
            f"the native {name} needs g++ to build, and there is none on "
            f"PATH{hint}"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [gxx, *flags, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


_carmen = None


def carmen_reader():
    """ctypes handle to the native Carmen log parser."""
    global _carmen
    if _carmen is None:
        lib = ctypes.CDLL(str(build("carmen_reader")))
        lib.carmen_load.restype = ctypes.c_void_p
        lib.carmen_load.argtypes = [ctypes.c_char_p]
        lib.carmen_free.argtypes = [ctypes.c_void_p]
        for fn in ("carmen_n_odom", "carmen_n_scan", "carmen_total_ranges"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        dptr = ctypes.POINTER(ctypes.c_double)
        for fn in ("carmen_export_odom", "carmen_export_scan_meta",
                   "carmen_export_ranges"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, dptr]
        _carmen = lib
    return _carmen


def carmen_load_arrays(path: str):
    """Parse a Carmen log natively: (odom ``[n, 7]``, scan meta ``[n,
    16]``, ranges ``[total]``) f64 arrays; raises OSError if the file
    cannot be read."""
    lib = carmen_reader()
    h = lib.carmen_load(os.fsencode(path))
    if not h:
        raise OSError(f"cannot read Carmen log: {path}")
    try:
        dptr = ctypes.POINTER(ctypes.c_double)
        odom = np.empty((lib.carmen_n_odom(h), 7), np.float64)
        meta = np.empty((lib.carmen_n_scan(h), 16), np.float64)
        ranges = np.empty(lib.carmen_total_ranges(h), np.float64)
        if odom.size:
            lib.carmen_export_odom(h, odom.ctypes.data_as(dptr))
        if meta.size:
            lib.carmen_export_scan_meta(h, meta.ctypes.data_as(dptr))
        if ranges.size:
            lib.carmen_export_ranges(h, ranges.ctypes.data_as(dptr))
        return odom, meta, ranges
    finally:
        lib.carmen_free(h)


_csm = None


def csm_baseline():
    """ctypes handle to the CPU correlative-matching baseline."""
    global _csm
    if _csm is None:
        lib = ctypes.CDLL(str(build("csm_baseline", BASELINE_FLAGS)))
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.precompute_coarse_map.restype = None
        lib.precompute_coarse_map.argtypes = [
            fptr, fptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.correlative_search.restype = ctypes.c_double
        lib.correlative_search.argtypes = [
            fptr, fptr, ctypes.c_int, ctypes.c_int, fptr, fptr, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int),
        ]
        _csm = lib
    return _csm


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def cpu_precompute_coarse(prob: np.ndarray, win: int) -> np.ndarray:
    """The sliding-window-max coarse map of an f32 ``[rows, cols]`` map."""
    lib = csm_baseline()
    prob = np.ascontiguousarray(prob, np.float32)
    if prob.ndim != 2:
        raise ValueError(f"a [rows, cols] map, not {prob.shape}")
    out = np.empty_like(prob)
    lib.precompute_coarse_map(_fptr(prob), _fptr(out), prob.shape[0],
                              prob.shape[1], int(win))
    return out


def cpu_correlative_search(
    fine, coarse, ranges, angles, sensor_pose, resolution, offset_xy,
    win_x, win_y, win_t, step_theta, low_res,
    score_thresh=0.0, known_thresh=0.0,
):
    """The baseline's coarse-prune + fine-descend search: the best
    (x cells, y cells, theta index) offsets and the normalized score."""
    lib = csm_baseline()
    fine = np.ascontiguousarray(fine, np.float32)
    coarse = np.ascontiguousarray(coarse, np.float32)
    ranges = np.ascontiguousarray(ranges, np.float32)
    angles = np.ascontiguousarray(angles, np.float32)
    if fine.ndim != 2 or coarse.shape != fine.shape:
        raise ValueError(f"maps {fine.shape} and {coarse.shape}")
    if ranges.shape != angles.shape or ranges.ndim != 1:
        raise ValueError(f"beams {ranges.shape} and {angles.shape}")
    best = (ctypes.c_int * 3)()
    score = lib.correlative_search(
        _fptr(fine), _fptr(coarse), fine.shape[0], fine.shape[1],
        _fptr(ranges), _fptr(angles), len(ranges),
        float(sensor_pose[0]), float(sensor_pose[1]), float(sensor_pose[2]),
        float(resolution), float(offset_xy[0]), float(offset_xy[1]),
        int(win_x), int(win_y), int(win_t), float(step_theta), int(low_res),
        float(score_thresh), float(known_thresh), best,
    )
    return np.array([best[0], best[1], best[2]]), float(score)
