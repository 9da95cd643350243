"""loop.bb_bound_ms: the program's own ms per ``loop.detect`` in
``bb.bound`` below it (branch-and-bound's common part over the step's
candidates: staging, pyramids, beam cells, the hit-image build, the bound
sweeps, the block order and their one fetch), in the traced window's
unfenced half.  None where the program opens no such span."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    got = program_spans.unfenced(td)
    if got is None or not program_spans.count(got[0], "bb.bound"):
        return None
    return program_spans.per_span_ms(td, "bb.bound", "loop.detect",
                                     "loop.detect")
