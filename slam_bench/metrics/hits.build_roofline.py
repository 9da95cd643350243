"""hits.build_roofline: the hit-image builds' least possible time on the
card as a share of the device time of every operation they launch, the
zero fill included (``ops/csm.py:hit_images``, fenced).

The least time counts the bytes that must reach HBM before the build's
last operation ends, at 3.35 TB/s (``slam_bench/bounds.py``): the i32
crop rows and columns ``[rows, beams]`` read once, and the f32 images
``[rows, crop_rows, crop_cols]`` written once, less what the 50 MB L2
cache may still hold unwritten when the build ends (its write-back
follows after).  Counting the whole images reads above 100 % on the card
at two candidates' images (334 MB: 103.5 %): the zero fill's last lines
are still in L2 when its time ends.  The build is the scatter of one
count per (theta, beam) pair into the zeroed images: no operation count
comes near the bytes' time.

The device time is each fenced call's own: the device operations that
overlap its range (the fences before and after leave no other there).
A call whose operations the profiler did not record adds neither time
nor bytes; all calls of a cell have one shape, so each recorded call
counts the calls' mean least time."""

import bisect

from slam_bench.bounds import bound

# H100 SXM L2 cache (data sheet): the writes that may still be in it,
# unwritten to HBM, when a kernel ends.
L2_BYTES = 50 * 2**20

SPAN = "kernel.hits"
SPANS = [(SPAN, ["module:my_lidar_graph_slam_v2_tpu_torch.ops.csm:hit_images"])]

# The longest a device operation of a call may start before its range
# on the profiler's clock and still be looked at.
_LOOK_BACK_NS = 10_000_000


def _work(rows, cols, *, crop_rows, crop_cols):
    n, b = rows.shape
    images = n * crop_rows * crop_cols * 4
    return bound(max(images - L2_BYTES, 0) + 2 * n * b * 4, 0)[0]


WORK = {SPAN: _work}


def recorded_calls(profile, name):
    """(calls whose range overlaps a recorded device operation, those
    operations' seconds) over the ranges ``name`` in ``profile``
    (:func:`slam_bench.trace.read_profile`)."""
    dev = profile["device"]
    starts = [d[0] for d in dev]
    n, secs = 0, 0.0
    for s0, s1, span in profile["spans"]:
        if span != name:
            continue
        i = bisect.bisect_left(starts, s0 - _LOOK_BACK_NS)
        j = bisect.bisect_left(starts, s1)
        own = [d1 - d0 for d0, d1, _, _ in dev[i:j] if d1 > s0]
        if own:
            n += 1
            secs += sum(own) / 1e9
    return n, secs


def read(td):
    profile = getattr(td, "profile", None)
    calls = td.span_n.get(SPAN, 0)
    if not profile or not calls or not td.work_ms.get(SPAN):
        return None
    n, secs = recorded_calls(profile, SPAN)
    if not n or not secs:
        return None
    return 100.0 * td.work_ms[SPAN] / calls * n / 1e3 / secs
