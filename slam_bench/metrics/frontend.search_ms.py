"""frontend.search_ms: the program's own ms per keyframe in ``match.search``
(pool, coarse and fine sweeps, prunes and argmax: the correlative core,
each dense re-run one more) below ``frontend.match``, in the traced
window's unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_keyframe_ms(
        td, "match.search", "frontend.match")
