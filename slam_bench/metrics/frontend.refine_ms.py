"""frontend.refine_ms: the program's own ms per keyframe in ``match.refine``
(``gn_refine`` and the covariance) below ``frontend.match``, in the
traced window's unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    return program_spans.per_keyframe_ms(
        td, "match.refine", "frontend.match")
