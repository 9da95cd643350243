"""device.idle_pct: the share of the traced window's unfenced half in
which no operation ran on the device (``torch.profiler``'s device-only
activity; no span fences that half)."""

SPANS = []


def read(td):
    s = td.unfenced or {}
    if not s.get("window_s") or not s.get("busy_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
