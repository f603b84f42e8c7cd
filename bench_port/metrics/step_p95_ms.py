"""95th percentile, over every step of the window, of the device time
between the ends of consecutive steps (CUDA events recorded after each
step).  Needs 200 samples, so that ten lie beyond it."""

import numpy as np


def read(run, trace):
    if len(run["step_ms"]) < 200:
        return None
    return float(np.percentile(np.asarray(run["step_ms"], np.float64), 95))
