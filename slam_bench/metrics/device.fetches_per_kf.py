"""device.fetches_per_kf: the program's device-to-host transfers (its
``fetch`` spans, each one rise of ``Device.HostFetches``) per keyframe
of the traced window's unfenced half."""

from slam_bench import program_spans

SPANS = []
program_spans.start()


def read(td):
    got = program_spans.unfenced(td)
    if got is None:
        return None
    spans, kf = got
    return program_spans.count(spans, "fetch") / kf
