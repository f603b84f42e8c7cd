"""Host ms per engine step in the program's ``engine.alloc`` spans: the
output and scratch tensors the step allocates (and any memset), under
the profiler, over the session's ``engine.step`` count."""


def read(run, trace):
    try:
        from folve_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    stats = span_stats()
    step, alloc = stats.get("engine.step"), stats.get("engine.alloc")
    if not step or not alloc:
        return None
    return alloc["host_ms"] / step["count"]
