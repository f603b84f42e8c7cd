"""Device ms per step in every kernel that is not PyTorch's own: the
kernels the program built, found by exclusion, not by name."""


def read(run, trace):
    if trace is None or not trace.steps or not trace.device:
        return None
    return 1e3 * trace.device_s(torch_own=False) / trace.steps
