"""loop.wait_ms: the program's own ms per ``loop.detect`` in ``fetch`` below
it: the host waiting for the device in loop detection, in the traced
window's unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_span_ms(
        td, "fetch", "loop.detect", "loop.detect")
