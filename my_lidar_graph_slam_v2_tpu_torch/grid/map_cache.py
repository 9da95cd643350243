"""Device-resident quantized local-map raster cache.

Port of ``my_lidar_graph_slam_v2_tpu/grid/map_cache.py`` (the analogue of
the reference FPGA matcher's map cache,
``scan_matcher_correlative_fpga.cpp:254-270``): an LRU of u8 probability
rasters keyed by ``(local_map_id, version)``.

* On a miss, the f32 log-odds raster is quantized to u8 on the device
  (``ops/quant.py``); a compacted map hands over its u8 raster as is.
* On a hit, nothing is computed or moved.
* Each entry carries a ``coarse`` dict, so the matchers' pooled maps (the
  branch-and-bound pyramid, the correlative coarse maps) are built once
  per finished map however many loop queries hit it.

Hit, miss and eviction counters and the materialized-bytes series go to
the metric registry under the JAX package's names.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from ..matching.types import MapRaster
from ..metrics.registry import MetricManager
from ..ops import quant


@dataclass
class CacheEntry:
    prob_q: Any  # [H, W] u8 device raster
    observed: Any  # [H, W] bool device mask (shared with the LocalMap)
    offset_xy: np.ndarray
    version: int
    nbytes: int
    coarse: Dict = field(default_factory=dict)


class DeviceMapCache:
    """LRU cache of quantized local-map rasters keyed by LocalMapId."""

    def __init__(self, resolution: float = 0.05, max_entries: int = 64,
                 metrics=None):
        self.resolution = resolution
        self.max_entries = max_entries
        self._entries: "OrderedDict[int, CacheEntry]" = OrderedDict()
        m = metrics or MetricManager.instance()
        self._m_hits = m.counter("MapCache.Hits")
        self._m_misses = m.counter("MapCache.Misses")
        self._m_evictions = m.counter("MapCache.Evictions")
        self._m_bytes = m.value_sequence("MapCache.MaterializedBytes")
        self._m_resident = m.gauge("MapCache.ResidentBytes")

    def raster(self, local_map) -> MapRaster:
        """Quantized MapRaster of a LocalMap; device work only on a miss."""
        key = local_map.local_map_id
        version = getattr(local_map, "version", 0)
        e = self._entries.get(key)
        if e is not None and e.version == version:
            self._entries.move_to_end(key)
            self._m_hits.increment()
        else:
            if getattr(local_map, "logodds", None) is not None:
                prob_q = quant.quantize_prob(local_map.logodds,
                                             local_map.observed)
                observed = local_map.observed
                offset_xy = local_map.offset_xy
            else:
                # Compacted finished maps and maps carrying a prebuilt
                # raster; a raster that is already u8 is used as is.
                r = local_map.raster(self.resolution)
                prob_q = (r.prob if r.prob.dtype == torch.uint8
                          else quant.quantize_prob_f32(r.prob))
                observed = r.observed
                offset_xy = r.offset_xy
            h, w = prob_q.shape
            e = CacheEntry(prob_q=prob_q, observed=observed,
                           offset_xy=offset_xy, version=version,
                           nbytes=h * w)  # the bool mask is the map's own
            self._entries[key] = e
            self._entries.move_to_end(key)
            self._m_misses.increment()
            self._m_bytes.observe(e.nbytes)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self._m_evictions.increment()
            self._m_resident.set_value(
                float(sum(x.nbytes for x in self._entries.values()))
            )
        return MapRaster(e.prob_q, e.observed, self.resolution, e.offset_xy,
                         coarse=e.coarse)

    def invalidate(self, local_map_id: int) -> None:
        self._entries.pop(local_map_id, None)

    def clear(self) -> None:
        self._entries.clear()

    @property
    def stats(self) -> dict:
        return dict(
            entries=len(self._entries),
            hits=int(self._m_hits.value),
            misses=int(self._m_misses.value),
            evictions=int(self._m_evictions.value),
        )
