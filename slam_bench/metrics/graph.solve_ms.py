"""graph.solve_ms: the program's own ms per ``graph.solve``, the host's
dispatch of the LM's masked iterations (``optimize_core``), in the
traced window's unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_span_ms(
        td, "graph.solve", None, "graph.solve")
