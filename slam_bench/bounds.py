"""The least time an H100 could take for a CSM sweep call, from the call's
own arguments.

Peaks of an H100 SXM at its 700 W limit: HBM at 3.35 TB/s (data sheet);
int32 adds at 132 SMs x 64 INT32 lanes x the 1.98 GHz boost clock.  A
sweep reads each input byte once (the window, 2 B a cell for u8 and 8 B
for f32; 9 B per (theta, beam) of beam cells and mask; 8 B per tile
origin), writes each output byte once (a score and a known count, 4 B
each, per theta and offset), and adds once per (valid beam, theta,
offset): one int32 add for a u8 window, one 64-bit integer add, two int32
operations, for an f32 one.  The bound is the larger of bytes over the
bandwidth and operations over their rate.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_ADDS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes, ops, ops_per_s=INT32_ADDS_PER_S):
    """(bound in ms, "bytes" or "adds")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "adds")


def sweep_bound(n, t, b, in_r, in_c, k, n_off, valid, f32=False):
    """Bound of a sweep of ``n`` candidates, ``t`` thetas of ``b`` beams,
    an ``in_r`` x ``in_c`` window, ``k`` tile origins and ``n_off``
    offsets per candidate, ``valid`` valid (candidate, theta, beam)
    entries."""
    cell = 8 if f32 else 2
    nbytes = (n * in_r * in_c * cell + n * t * b * 9 + n * k * 8
              + n * t * 2 * n_off * 4)
    adds = valid * n_off
    return bound(nbytes, 2 * adds if f32 else adds)


def sweep_call_bound(win, hr, hc, ok, origins, *, tile_h, tile_w, stride):
    """:func:`sweep_bound` of one ``ops/csm.py:sweep`` call: window ``[N,
    in_r, in_c, 2]``, beams ``[N, T, B]``, origins ``[N, K, 2]``."""
    n, t, b = hr.shape
    return sweep_bound(n, t, b, win.shape[1], win.shape[2], origins.shape[1],
                       origins.shape[1] * tile_h * tile_w, int(ok.sum()),
                       f32=str(win.dtype) == "torch.float32")
