"""loop.bb_descend_ms: the program's own ms per ``loop.detect`` in
``bb.descend`` below it (branch-and-bound's block descent over the step's
candidates, every round with its fetch), in the traced window's unfenced
half.  None where the program opens no such span."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    got = program_spans.unfenced(td)
    if got is None or not program_spans.count(got[0], "bb.descend"):
        return None
    return program_spans.per_span_ms(td, "bb.descend", "loop.detect",
                                     "loop.detect")
