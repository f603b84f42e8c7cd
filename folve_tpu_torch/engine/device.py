"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a
    usable card raises here instead of deep inside the first kernel.
    A bare ``"cuda"`` names the current card (``cuda:<index>``), the
    device its tensors report, so devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
