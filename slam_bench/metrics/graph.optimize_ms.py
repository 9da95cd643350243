"""graph.optimize_ms: fenced ms per pose-graph optimisation
(``graph/optimizer.py``, the LM)."""

SPANS = [("graph.optimize", ["backend.optimizer.optimize"])]


def read(td):
    n = td.span_n.get("graph.optimize", 0)
    return 1e3 * td.span_s["graph.optimize"] / n if n else None
