"""graph.capture_share: the program's ``graph.capture`` spans (a CUDA
graph of the LM captured for a new shape bucket, below ``graph.solve``)
over its ``graph.solve`` spans, in the traced window's unfenced half: 0
where every call replayed or ran eagerly; None where the LM never ran."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    got = program_spans.unfenced(td)
    if got is None:
        return None
    spans, _ = got
    n = program_spans.count(spans, "graph.solve")
    if not n:
        return None
    return program_spans.count(spans, "graph.capture", "graph.solve") / n
