"""The step's bound (``roofline.Step.bound``: the larger of its bytes
over 3.35 TB/s and its operations over 67 TFLOP/s) as a share of the
device's busy ms per step in the traced stretch, in %."""


def read(run, trace):
    if trace is None or not trace.steps or not trace.device:
        return None
    busy_ms = 1e3 * trace.busy_s / trace.steps
    return 100.0 * run["bound"]["bound_ms"] / busy_ms
