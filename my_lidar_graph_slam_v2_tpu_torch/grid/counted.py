"""Counting-cell occupancy raster (hit count / observation count).

Port of ``my_lidar_graph_slam_v2_tpu/grid/counted.py`` (the reference's
``GridCounted``, ``grid_map_new/grid_counted.{hpp,cpp}``): each cell
counts its hits and its observations, its probability is their ratio
(``GridCounted::UpdateUnchecked``, ``grid_counted.cpp:286-305``), and its
u16 value goes through the codec of ``grid/values.py`` (0 = unknown).
Nothing in the pipeline builds it, as in the reference; it is here for
the cell family's completeness.

The state is two int32 planes on ``device``; an update is one
``index_add_`` per plane over the whole batch of cells (duplicates add
up, as sequential per-cell updates would), with out-of-raster and invalid
entries adding 0 at cell 0 rather than being filtered out, so no update
waits for the host.
"""
from __future__ import annotations

import torch

from ..utils.transfer import to_device
from . import values as gv


def _on(a, device):
    """``a``, a tensor or anything NumPy takes, on ``device``."""
    return a.to(device) if torch.is_tensor(a) else to_device(a, device)


class GridCounted:
    """Fixed-extent counting raster on ``device``: int32 ``hits`` and
    ``counts`` ``[rows, cols]``; the u16 and u8 value planes are derived
    views."""

    def __init__(self, rows: int, cols: int, device):
        self.rows = rows
        self.cols = cols
        self.device = torch.device(device)
        self.hits = torch.zeros((rows, cols), dtype=torch.int32,
                                device=self.device)
        self.counts = torch.zeros_like(self.hits)

    def reset(self):
        """``GridCounted::ResetValues``: every cell back to unknown."""
        self.hits.zero_()
        self.counts.zero_()

    def update(self, rows_idx, cols_idx, hit, valid=None):
        """Batched observation update (``GridCounted::Update`` over a set
        of cells): ``counts += 1`` and ``hits += hit`` at each (row, col)
        inside the raster whose ``valid`` (if given) is true."""
        r = _on(rows_idx, self.device).long()
        c = _on(cols_idx, self.device).long()
        ok = (r >= 0) & (r < self.rows) & (c >= 0) & (c < self.cols)
        if valid is not None:
            ok = ok & _on(valid, self.device).bool()
        idx = torch.where(ok, r * self.cols + c, 0)
        inc = ok.to(torch.int32)
        self.counts.view(-1).index_add_(0, idx, inc)
        self.hits.view(-1).index_add_(
            0, idx, inc * _on(hit, self.device).bool())

    def prob(self):
        """f32 probability plane, unknown (never observed) = 0.0."""
        p = torch.div(self.hits.to(torch.float32),
                      torch.clamp(self.counts.to(torch.float32), min=1.0))
        return torch.where(self.counts > 0, p, gv.UNKNOWN_PROB)

    @property
    def observed(self):
        return self.counts > 0

    def _values(self):
        """The u16 codes as int32 (``GridCounted::ProbabilityToValue``,
        ``grid_counted.cpp:332-346``): 0 for unknown, the clamped linear
        code otherwise, in the JAX module's f32 arithmetic."""
        scale = (gv.VALUE_MAX - gv.VALUE_MIN) / (gv.PROB_MAX - gv.PROB_MIN)
        v = gv.VALUE_MIN + (self.prob() - gv.PROB_MIN) * scale
        v = torch.clamp(torch.round(v), gv.VALUE_MIN, gv.VALUE_MAX)
        return torch.where(self.counts > 0, v.to(torch.int32),
                           gv.UNKNOWN_VALUE)

    def values_u16(self):
        """u16 value plane through the shared codec."""
        return self._values().to(torch.uint16)

    def values_u8(self):
        """u8 view = value >> 8 (``GridCounted::CopyValuesU8``)."""
        return (self._values() >> 8).to(torch.uint8)

    def memory_usage(self) -> int:
        """Device bytes held: the two int32 planes."""
        return (self.hits.numel() + self.counts.numel()) * 4
