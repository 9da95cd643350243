"""frontend.fold_ms: the program's own ms per keyframe in ``match.fold``
(the latest-map fold and u8 quantize, ``models/fused_matcher.py:
fused_core_deltas``) below ``frontend.match``, in the traced window's
unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_keyframe_ms(
        td, "match.fold", "frontend.match")
