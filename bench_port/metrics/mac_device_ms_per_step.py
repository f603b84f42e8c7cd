"""Device ms a step in kernel 1's MAC phase: the kernels named
``mac_kernel`` (phase B of ``conv_step.cu``) in the traced stretch,
counted as the port's other device metrics count them, over its steps.
None where the stretch holds no such kernel."""

from bench_port.trace import short_name


def read(run, trace):
    if trace is None or not trace.steps or not trace.device:
        return None
    w0, w1 = trace.window
    secs = sum(t1 - t0 for name, cat, t0, t1 in trace.device
               if cat == "kernel" and t0 < w1 and t1 > w0
               and short_name(name) == "mac_kernel")
    return 1e3 * secs / trace.steps if secs else None
