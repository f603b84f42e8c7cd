"""Device ms per engine step in the program's ``engine.monitor`` spans
(the clipping monitor), from each span's CUDA event pair, over the
session's ``engine.step`` count; None without a card."""


def read(run, trace):
    try:
        from folve_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    stats = span_stats()
    step, mon = stats.get("engine.step"), stats.get("engine.monitor")
    if not step or not mon or mon["device_ms"] is None:
        return None
    return mon["device_ms"] / step["count"]
