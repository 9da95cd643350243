"""hits.sweep_roofline: branch-and-bound's bound and block sweeps
(``ops/csm.py:sweep_from_hits_batch``, fenced) counted as the CSM sweep
of the same poses would be (``slam_bench/bounds.py:sweep_bound``: each
window's crop read once, T x B beam cells, one tile origin, the offsets'
scores and known counts written once, one add per valid (theta, beam)
pair and offset), as a share of the device time of every operation the
calls launch.  The count is the work, whatever implements it: a hit-image
product today, the CSM sweep kernel if the sweeps move there."""

from slam_bench.bounds import sweep_bound

SPANS = [("kernel.hits_sweep",
          ["module:my_lidar_graph_slam_v2_tpu_torch.ops.csm:"
           "sweep_from_hits_batch"])]

# The last batch's crop rows and its valid (theta, beam) pairs per
# candidate: a step's sweeps all read one batch of hit images.
_last = [None, None]


def _work(hits, prob, observed, x0, y0, *, nx, ny, stride, precision, cand,
          map_index=None):
    _, t, cr, cc = hits.img.shape
    b = hits.rows.shape[-1]
    if _last[0] is not hits.rows:
        _last[:] = hits.rows, (hits.rows >= 0).sum(dim=(1, 2)).tolist()
    pairs = _last[1]
    f32 = str(prob.dtype) != "torch.uint8" or precision == "highest"
    return sweep_bound(len(cand), t, b, cr + (ny - 1) * stride,
                       cc + (nx - 1) * stride, 1, nx * ny,
                       sum(pairs[c] for c in cand), f32=f32)[0]


WORK = {"kernel.hits_sweep": _work}


def read(td):
    s = getattr(td, "device_summary", {}) or {}
    dev = s.get("span_device_s", {}).get("kernel.hits_sweep", 0.0)
    if not dev or not td.work_ms.get("kernel.hits_sweep"):
        return None
    return 100.0 * td.work_ms["kernel.hits_sweep"] / 1e3 / dev
