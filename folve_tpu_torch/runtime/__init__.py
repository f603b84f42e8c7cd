"""Runtime that feeds the device: the block pump and the batch scheduler."""

from folve_tpu_torch.runtime.processor import SoundProcessor
from folve_tpu_torch.runtime.scheduler import DeviceScheduler, FusedStateRef

__all__ = ["DeviceScheduler", "FusedStateRef", "SoundProcessor"]
