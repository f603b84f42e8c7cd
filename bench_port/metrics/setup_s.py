"""Seconds from the harness's start (before torch is imported) to the
window's first step: CUDA context, kernel load or build, the filter's
parse and compile, state and ring allocation, the warm-up steps."""


def read(run, trace):
    return run["setup_s"]
