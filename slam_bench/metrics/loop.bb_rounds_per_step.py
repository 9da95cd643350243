"""loop.bb_rounds_per_step: the program's ``bb.round`` spans (one round
of branch-and-bound's lockstep descent: each live candidate's next blocks
swept in one call and fetched once) per ``loop.detect``, in the traced
window's unfenced half.  None where the program opens no ``bb.descend``
span: a program without the batched descent."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    got = program_spans.unfenced(td)
    if got is None:
        return None
    spans, _ = got
    n = program_spans.count(spans, "loop.detect")
    if not n or not program_spans.count(spans, "bb.descend"):
        return None
    return program_spans.count(spans, "bb.round", "loop.detect") / n
