"""Device ms per engine step in the program's ``engine.state`` spans
(the new state's copies and concatenations), from each span's CUDA
event pair, over the session's ``engine.step`` count; None without a
card."""


def read(run, trace):
    try:
        from folve_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    stats = span_stats()
    step, state = stats.get("engine.step"), stats.get("engine.state")
    if not step or not state or state["device_ms"] is None:
        return None
    return state["device_ms"] / step["count"]
