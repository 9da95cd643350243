"""graph.prepare_ms: the program's own ms per ``graph.prepare`` (the
information clip, the pose and edge uploads, the Schur pairs:
``graph/optimizer.py:optimize``), in the traced window's unfenced
half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_span_ms(
        td, "graph.prepare", None, "graph.prepare")
