"""GFLOP a step in kernel 1's MAC: 8 FLOP per complex multiply-add, over
the multiply-adds the program's wrapper asked of its launches
(``conv_step_fused.mac_terms``: S x T x P x the paths it passed x the
stored bins, counted at each launch), per launch.  It reads the paths
the wrapper handed the kernel, not the body the kernel ran over them:
``mac_device_ms_per_step`` shows whether the kernel skipped the pairs
left out.  None for a program without the counter."""


def read(run, trace):
    try:
        from folve_tpu_torch.engine.kernels.conv_step import conv_step_fused
    except ImportError:
        return None
    terms = getattr(conv_step_fused, "mac_terms", None)
    launches = getattr(conv_step_fused, "launches", None)
    if not terms or not launches:
        return None
    return 8.0 * terms / launches / 1e9
