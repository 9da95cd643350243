"""loop.search_ms: the program's own ms per ``loop.detect`` in
``match.search`` below it (the batched core with its staging, or the
serial core per candidate, and the dense re-runs), in the traced
window's unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_span_ms(
        td, "match.search", "loop.detect", "loop.detect")
