"""SE(2) pose algebra on NumPy arrays, after the reference's ``pose.hpp``
(compound, inverse compound, distance): a frozen copy of the plain NumPy
formulas, so the benchmark's course generator and its reference need
nothing of the program."""
from __future__ import annotations

import numpy as np


def compound(start, diff):
    """``Compound(startPose, diffPose)``."""
    start = np.asarray(start)
    diff = np.asarray(diff)
    s, c = np.sin(start[..., 2]), np.cos(start[..., 2])
    x = c * diff[..., 0] - s * diff[..., 1] + start[..., 0]
    y = s * diff[..., 0] + c * diff[..., 1] + start[..., 1]
    t = start[..., 2] + diff[..., 2]
    return np.stack([x, y, t], axis=-1)


def inverse_compound(start, end):
    """``InverseCompound(startPose, endPose)``: ``end`` in ``start``'s
    frame."""
    start = np.asarray(start)
    end = np.asarray(end)
    s, c = np.sin(start[..., 2]), np.cos(start[..., 2])
    dx = end[..., 0] - start[..., 0]
    dy = end[..., 1] - start[..., 1]
    x = c * dx + s * dy
    y = -s * dx + c * dy
    t = end[..., 2] - start[..., 2]
    return np.stack([x, y, t], axis=-1)


def distance(p):
    """Euclidean length of the (x, y) part."""
    p = np.asarray(p)
    return np.hypot(p[..., 0], p[..., 1])

