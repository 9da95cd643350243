"""device.profiled_keyframes_per_s: keyframes per second in the traced
window's unfenced half, under its device-only profile, beside which
``device.idle_pct`` and ``device.launches_per_kf`` are read: against the
untraced run's ``keyframes_per_s`` it shows how far the profile slows the
host, and so how far the idle share overstates the program's own."""

SPANS = []


def read(td):
    s = td.unfenced or {}
    if not s.get("window_s") or not s.get("keyframes"):
        return None
    return s["keyframes"] / s["window_s"]
