"""sweep_roofline: the CSM sweep calls' least possible time on
the card (``slam_bench/bounds.py``, counted from each call's arguments)
as a share of the device time of every kernel those calls launched
(``ops/csm.py:sweep``, fenced, so its kernels lie inside its range in
the profiler's trace)."""

from slam_bench.bounds import sweep_call_bound

SPANS = [("kernel.sweep",
          ["module:my_lidar_graph_slam_v2_tpu_torch.ops.csm:sweep"])]


def _work(win, hr, hc, ok, origins, *, tile_h, tile_w, stride):
    return sweep_call_bound(win, hr, hc, ok, origins, tile_h=tile_h,
                            tile_w=tile_w, stride=stride)[0]


WORK = {"kernel.sweep": _work}


def read(td):
    s = getattr(td, "device_summary", {}) or {}
    dev = s.get("span_device_s", {}).get("kernel.sweep", 0.0)
    if not dev or not td.work_ms.get("kernel.sweep"):
        return None
    return 100.0 * td.work_ms["kernel.sweep"] / 1e3 / dev
