"""The program's own spans, read for the per-layer metrics.

The port's metric registry (``metrics/registry.py``) records, with its
tracing on, every span the program opens: ``(name, parent, t0_ns,
t1_ns, thread)``, ``parent`` the ``/``-joined path of the spans open
around it.  The facade closes one record per keyframe, as the harness
counts keyframes, so the traced window's unfenced half is the slice
``[-(U + F):-F]`` of the records (``U`` its keyframes, ``F`` the fenced
half's; to the end when ``F`` is 0): the program's own times with no
fence of the benchmark's.  A module that reads them calls :func:`start`
when it loads, before the warm-up.  A program without the registry's
tracing leaves every reader with nothing: they return None.
"""
from __future__ import annotations


def _manager():
    try:
        from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
            MetricManager,
        )
    except ImportError:
        return None
    return MetricManager.instance()


def start():
    """Turn the program's tracing on, where the program has it, without
    its profiler ranges: the traced window's fenced half profiles host and
    device, where each range's mirror on the device's timeline would read
    as a device operation (``trace.read_profile`` skips only the
    benchmark's own), moving ``sweep_roofline`` and the idle breakdown."""
    mm = _manager()
    if mm is not None and hasattr(mm, "start_tracing"):
        mm.start_tracing(ranges=False)


def unfenced(td, records=None):
    """(spans, keyframes) of the traced window's unfenced half, or None
    where that half was not measured or the program kept no records.
    ``records`` stands in for the program's (tests)."""
    un = td.unfenced
    if not un or not un.get("keyframes"):
        return None
    if records is None:
        mm = _manager()
        if mm is None or not hasattr(mm, "trace_records"):
            return None
        records = mm.trace_records()
    U, F = un["keyframes"], (td.counts or {}).get("keyframes", 0)
    part = records[-(U + F):-F] if F else records[-U:]
    if len(part) != U:
        return None
    return [s for r in part for s in r.spans], U


def _of(spans, name, under):
    return [s for s in spans if s[0] == name
            and (under is None or under in s[1].split("/"))]


def count(spans, name, under=None) -> int:
    """Spans called ``name``, below a span called ``under`` if given."""
    return len(_of(spans, name, under))


def total_ms(spans, name, under=None) -> float:
    """Their summed duration, ms."""
    return sum(s[3] - s[2] for s in _of(spans, name, under)) / 1e6


def per_keyframe_ms(td, name, under):
    """ms of ``name`` below ``under`` per keyframe of the unfenced half."""
    got = unfenced(td)
    if got is None:
        return None
    spans, kf = got
    return total_ms(spans, name, under) / kf


def per_span_ms(td, name, under, per):
    """ms of ``name`` (below ``under`` if given) per span called ``per``
    in the unfenced half; None where there is no such span."""
    got = unfenced(td)
    if got is None:
        return None
    spans, _ = got
    n = count(spans, per)
    return total_ms(spans, name, under) / n if n else None
