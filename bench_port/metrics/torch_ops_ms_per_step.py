"""Device ms per step in PyTorch's own work: ATen kernels (the clipping
monitor, cat, contiguous copies, elementwise ops), copies and memsets."""


def read(run, trace):
    if trace is None or not trace.steps or not trace.device:
        return None
    return 1e3 * trace.device_s(torch_own=True) / trace.steps
