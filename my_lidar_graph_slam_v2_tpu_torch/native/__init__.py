"""The native (C++) Carmen log parser, loaded with ctypes.

``carmen_reader.cpp`` is the JAX package's parser, copied unchanged.  It
is compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` at first use into
``build/native/`` at the root of the checkout, under a name that carries a
hash of the source and the flags, and never next to the sources.  There
is no ``-march=native``: one build serves any host.  Nothing is built when
this module is imported.
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


def library_path(name: str) -> Path:
    """Where the library of ``<name>.cpp`` is cached."""
    src = (SRC_DIR / f"{name}.cpp").read_bytes()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless it is built already; raises if there
    is no ``g++`` or the compile fails."""
    lib = library_path(name)
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            f"the native {name} needs g++ to build, and there is none on "
            "PATH; read the log with native=False or None (the Python "
            "reader)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [gxx, *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
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
