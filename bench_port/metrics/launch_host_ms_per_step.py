"""Host ms per engine step in the program's ``kernel.*`` spans: each
CUDA kernel wrapper's launch (its ctypes call), under the profiler,
over the session's ``engine.step`` count."""


def read(run, trace):
    try:
        from folve_tpu_torch.utils.profiling import span_stats
    except ImportError:  # a program without spans
        return None
    stats = span_stats()
    step = stats.get("engine.step")
    kernels = [v for k, v in stats.items() if k.startswith("kernel.")]
    if not step or not kernels:
        return None
    return sum(v["host_ms"] for v in kernels) / step["count"]
