"""Carry the JAX package's arrays into the port and back.

Both packages use the same public layouts (filter spectra
``[P, Cin, Cout, 2, K]``, :class:`StreamState`, the fused serving
carry), so every conversion is a copy of numpy arrays onto a device.
Pass the JAX side's arrays through ``numpy.asarray`` first; nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.filter_bank import FilterBank
from folve_tpu_torch.engine.stream import FusedServingCarry, StreamState


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def bank_from_numpy(h_spec, fragm: int, size: int, device="cuda") -> FilterBank:
    """A :class:`FilterBank` from the JAX bank's ``h_spec`` array."""
    return FilterBank(h_spec=_t(h_spec, resolve_device(device)), fragm=fragm,
                      size=size)


def state_from_numpy(hist_re, hist_im, tail, max_abs, device="cuda") -> StreamState:
    """A :class:`StreamState` (batched or not) from the JAX state's fields."""
    dev = resolve_device(device)
    return StreamState(_t(hist_re, dev), _t(hist_im, dev), _t(tail, dev),
                       _t(max_abs, dev))


def state_to_numpy(state) -> tuple:
    """``(hist_re, hist_im, tail, max_abs)`` as host numpy arrays."""
    return tuple(getattr(state, f).detach().cpu().numpy()
                 for f in ("hist_re", "hist_im", "tail", "max_abs"))


def carry_from_numpy(hist_re, hist_im, tail, max_abs,
                     device="cuda") -> FusedServingCarry:
    """A :class:`FusedServingCarry` from the JAX carry's fields
    (hist [S, P-1, Cin, cols, m1] oldest row first, so ring head 0;
    tail [S, Cout, rows, m2], max [S])."""
    dev = resolve_device(device)
    return FusedServingCarry(_t(hist_re, dev), _t(hist_im, dev),
                             _t(tail, dev), _t(max_abs, dev))
