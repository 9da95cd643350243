"""The port's registry counters that stand for what its objects once
counted themselves: read one before a call and after it, and compare the
rise."""
from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import MetricManager


def host_fetches() -> float:
    """``Device.HostFetches``: the device-to-host transfers so far."""
    return MetricManager.instance().counter("Device.HostFetches").value


def kernel_refines() -> float:
    """``GaussNewton.KernelRefines``: the refinements the CUDA kernel ran
    so far."""
    return MetricManager.instance().counter("GaussNewton.KernelRefines").value


def dense_reruns() -> float:
    """``LoopDetector.DenseReruns``: the batched detector's candidates
    re-run densely so far."""
    return MetricManager.instance().counter("LoopDetector.DenseReruns").value


def graph_captures() -> float:
    """``PoseGraphOptimizerLM.GraphCaptures``: the LM's CUDA graphs
    captured so far, one per new shape bucket."""
    return MetricManager.instance().counter(
        "PoseGraphOptimizerLM.GraphCaptures").value


def graph_replays() -> float:
    """``PoseGraphOptimizerLM.GraphReplays``: the LM calls that replayed a
    captured CUDA graph so far."""
    return MetricManager.instance().counter(
        "PoseGraphOptimizerLM.GraphReplays").value


class FetchesOf:
    """The host fetches made inside ``obj``'s ``method`` from now on, as
    the object once counted its own: ``n`` sums the rise of
    ``Device.HostFetches`` over each call."""

    def __init__(self, obj, method: str = "optimize_pose"):
        self.n = 0
        call = getattr(obj, method)

        def counted(*args, **kw):
            f0 = host_fetches()
            try:
                return call(*args, **kw)
            finally:
                self.n += host_fetches() - f0

        setattr(obj, method, counted)


class PerCall:
    """Each call of ``obj``'s ``method`` from now on, as a dict in
    ``calls``: the rise of every counter of ``counters`` (name: a function
    returning its running count) over the call, and ``size``, the length
    of its first argument where it has one (a batch of queries)."""

    def __init__(self, obj, method: str, **counters):
        self.calls = []
        call = getattr(obj, method)

        def counted(*args, **kw):
            before = {k: c() for k, c in counters.items()}
            out = call(*args, **kw)
            row = {k: c() - before[k] for k, c in counters.items()}
            if args and hasattr(args[0], "__len__"):
                row["size"] = len(args[0])
            self.calls.append(row)
            return out

        setattr(obj, method, counted)

    def total(self, key: str):
        return sum(c[key] for c in self.calls)
