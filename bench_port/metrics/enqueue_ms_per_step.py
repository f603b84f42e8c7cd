"""Host ms per call into the engine's step (the benchmark's ``enqueue``
span: the step's Python and its launches), the mean over every step of
the window outside the profiled stretch, whose profiler slows the host."""


def read(run, trace):
    if not run["enqueue_ms"]:
        return None
    return sum(run["enqueue_ms"]) / len(run["enqueue_ms"])
