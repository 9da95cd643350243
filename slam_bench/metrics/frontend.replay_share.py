"""frontend.replay_share: the program's ``search.replay`` spans (a
frontend search run as the replay of a CUDA graph captured at an earlier
call, below ``match.search``) over its ``match.search`` spans below
``frontend.match``, in the traced window's unfenced half.  None where
the frontend never searched, where the program keeps no spans, and where
no search of the half was captured or replayed: a program that runs its
search eagerly throughout has no such span to read."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    got = program_spans.unfenced(td)
    if got is None:
        return None
    spans, _ = got
    n = program_spans.count(spans, "match.search", "frontend.match")
    replays = program_spans.count(spans, "search.replay", "frontend.match")
    if not n or not (replays or program_spans.count(
            spans, "search.capture", "frontend.match")):
        return None
    return replays / n
