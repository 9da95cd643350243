"""What the port's measurement scripts share: the device a script runs on,
the card's name and power limit as ``nvidia-smi`` reports them, peak
device memory, and the least time the card could take for a sweep.

The peaks behind every bound are those of an H100 SXM at its 700 W limit:
HBM bytes/s from the data sheet, int32 adds/s as 132 SMs x 64 INT32 lanes
x the 1.98 GHz boost clock, f64 adds/s likewise from the 64 FP64 lanes of
an SM, and f32 operations/s outside the tensor cores from the data
sheet.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

HBM_BYTES_PER_S = 3.35e12
INT32_ADDS_PER_S = 132 * 64 * 1.98e9
F64_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 67e12


def bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_bound(s, ok, f32=False):
    """Bound of one sweep of shape ``s`` (``N``, ``T``, ``B``, the window
    ``in_r`` x ``in_c``, tile origins ``origins`` ``[N, K, 2]`` and
    ``n_off`` offsets per candidate): each input byte read once (window,
    beam cells and mask, tile origins), each output byte written once, and
    the adds per (valid beam, offset) of this input's mask ``ok``.  A u8
    window (2 B a cell) takes one int32 add: a cell's two u8 values fit in
    one 32-bit word (p | o << 16) and a warp's sums cannot carry between
    the halves, as the kernel adds them.  An f32 window (``f32``, 8 B a
    cell) takes one 64-bit integer add, two 32-bit ops: the kernel packs a
    cell's two channels into one u64 of exact fixed point (m | obs << 56)."""
    N, T, B, K = s["N"], s["T"], s["B"], s["origins"].shape[1]
    cell = 8 if f32 else 2
    nbytes = (N * s["in_r"] * s["in_c"] * cell + N * T * B * 9 + N * K * 8
              + N * T * 2 * s["n_off"] * 4)
    adds = int(ok.sum()) * s["n_off"]
    if f32:
        return bound(nbytes, 2 * adds, INT32_ADDS_PER_S)
    return bound(nbytes, adds, INT32_ADDS_PER_S)


def sweep_call_bound(win, hr, ok, origins, *, tile_h, tile_w):
    """:func:`sweep_bound` of one ``ops/csm.py:sweep`` call's arguments."""
    N, T, B = hr.shape
    s = dict(N=N, T=T, B=B, in_r=win.shape[1], in_c=win.shape[2],
             origins=origins, n_off=origins.shape[1] * tile_h * tile_w)
    return sweep_bound(s, ok, f32=win.dtype == torch.float32)


def nvidia_smi() -> str:
    """The card's ``name, power.limit`` line of ``nvidia-smi``."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def card(device: torch.device) -> dict:
    """Where a result was measured: ``platform`` (``gpu`` or ``cpu``), the
    device's kind, and on the card its name and power limit."""
    if device.type != "cuda":
        return dict(platform="cpu", device_kind="cpu", device_name=None,
                    power_limit=None)
    name, limit = (f.strip() for f in nvidia_smi().split(",", 1))
    return dict(platform="gpu", device_kind=torch.cuda.get_device_name(device),
                device_name=name, power_limit=limit)


def script_device(name: str, prog: str) -> torch.device:
    """The ``--device`` of a script; a CUDA device without a card ends the
    script with exit code 2, as the launcher does (the CPU runs only when
    asked for)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: --device {name} but CUDA is not available; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        raise SystemExit(2)
    return device


def peak_device_mb(device: torch.device):
    """Peak device memory allocated since the last reset, in MiB (None on
    the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def child_env() -> dict:
    """This process's environment with the checkout first on
    ``PYTHONPATH``, for a child that runs a module of the port."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env
