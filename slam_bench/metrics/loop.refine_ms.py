"""loop.refine_ms: the program's own ms per ``loop.detect`` in
``match.refine`` below it (the final matcher's or the fused matcher's
Gauss-Newton and covariance), in the traced window's unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_span_ms(
        td, "match.refine", "loop.detect", "loop.detect")
