"""Host ms per engine step inside the program's ``engine.step`` span
(``folve_tpu_torch.utils.profiling.span_stats``, the session the traced
stretch and its tail recorded): the step's Python, allocations and
launches, slowed by the profiler that records it."""


def read(run, trace):
    try:
        from folve_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    step = span_stats().get("engine.step")
    if not step:
        return None
    return step["host_ms"] / step["count"]
