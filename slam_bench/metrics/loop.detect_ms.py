"""loop.detect_ms: fenced ms per backend step that ran loop detection
(``parallel/loop_sharded.py`` batched or ``loop/detector.py`` serial, with
the final matcher)."""

SPANS = [("loop.detect", ["backend.loop_detector.detect"])]


def read(td):
    n = td.span_n.get("loop.detect", 0)
    return 1e3 * td.span_s["loop.detect"] / n if n else None
