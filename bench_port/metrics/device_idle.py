"""Share of the traced stretch in which no kernel, copy or memset ran
on the device, in %."""


def read(run, trace):
    if trace is None or not trace.steps or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
