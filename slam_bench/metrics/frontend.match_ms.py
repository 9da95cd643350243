"""frontend.match_ms: fenced ms of the frontend's scan match per keyframe
of the window (``models/fused_matcher.py``: latest-map fold, correlative
core with the CSM sweeps, Gauss-Newton refinement, covariance)."""

SPANS = [("frontend.match", ["frontend.scan_matcher.optimize_pose_deltas",
                             "frontend.scan_matcher.optimize_pose"])]


def read(td):
    kf = td.counts.get("keyframes", 0)
    if not kf or "frontend.match" not in td.span_s:
        return None
    return 1e3 * td.span_s["frontend.match"] / kf
