"""frontend.wait_ms: the program's own ms per keyframe in ``fetch`` below
``frontend.match``: the host waiting for the device at the match's
transfers, in the traced window's unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_keyframe_ms(
        td, "fetch", "frontend.match")
