"""device.launches_per_kf: kernels the device ran in the traced window's
unfenced half per keyframe of that half."""

SPANS = []


def read(td):
    s = td.unfenced or {}
    kf = s.get("keyframes", 0)
    if not s.get("launches") or not kf:
        return None
    return s["launches"] / kf
