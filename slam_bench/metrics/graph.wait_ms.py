"""graph.wait_ms: the program's own ms per ``graph.optimize`` in ``fetch``
below it: the host waiting for the LM's result, in the traced window's
unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_span_ms(
        td, "fetch", "graph.optimize", "graph.optimize")
