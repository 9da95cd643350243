"""frontend.dense_share: dense re-runs per frontend match, the
``match.search`` spans below ``frontend.match`` over the
``frontend.match`` spans, less one, in the traced window's unfenced
half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    got = program_spans.unfenced(td)
    if got is None:
        return None
    spans, _ = got
    n = program_spans.count(spans, "frontend.match")
    if not n:
        return None
    searches = program_spans.count(spans, "match.search", "frontend.match")
    return searches / n - 1
