"""FilterBank — a FIR filter compiled for the partitioned-convolution engine.

``h_spec`` holds the DFT of every zero-padded ``fragm``-tap partition for
every (input, output) channel pair, laid out ``[P, Cin, Cout, 2, K]``:
real/imag planes with ``K`` bins of a ``2*fragm``-point DFT in the
permuted layout of :mod:`folve_tpu_torch.engine.rfft` (the JAX package's
layout exactly).  The spectra are computed on the host in float64 and are
bit-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from folve_tpu_torch.engine.constants import (
    MAXINP,
    MAXOUT,
    MAXSIZE,
    derive_fragm,
    num_partitions,
)
from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.rfft import permute_spectrum


@dataclasses.dataclass(frozen=True, eq=False)
class FilterBank:
    """Compiled filter partitions in the frequency domain.

    ``h_spec``: float32 tensor ``[P, Cin, Cout, 2, K]`` on the bank's
    device.  Entry ``[p, i, o]`` is the spectrum of taps
    ``[p*fragm, (p+1)*fragm)`` of the impulse response from input
    channel ``i`` to output channel ``o``.
    """

    h_spec: torch.Tensor
    fragm: int
    size: int

    @property
    def partitions(self) -> int:
        return self.h_spec.shape[0]

    @property
    def ninp(self) -> int:
        return self.h_spec.shape[1]

    @property
    def nout(self) -> int:
        return self.h_spec.shape[2]

    @property
    def bins(self) -> int:
        return self.h_spec.shape[4]

    @property
    def device(self) -> torch.device:
        return self.h_spec.device


def compile_filter_bank(
    ir: np.ndarray,
    fragm: Optional[int] = None,
    size: Optional[int] = None,
    layout: str = "half",
    device="cuda",
) -> FilterBank:
    """Compile a dense impulse-response tensor ``[Cin, Cout, L]`` into a
    :class:`FilterBank` on ``device``.

    ``size``: declared filter length (defaults to ``L``); ``fragm``
    defaults to the reference's derivation from ``size``.  ``layout``:
    "half" (default) stores only the half-spectrum rectangle; "full"
    keeps all bins."""
    dev = resolve_device(device)
    planes, fragm, size = compute_spectra_planes(ir, fragm, size, layout)
    return FilterBank(h_spec=torch.from_numpy(planes).to(dev), fragm=fragm,
                      size=size)


def compute_spectra_planes(
    ir: np.ndarray,
    fragm: Optional[int] = None,
    size: Optional[int] = None,
    layout: str = "half",
):
    """Host-side spectra computation behind :func:`compile_filter_bank`;
    returns ``(planes, fragm, size)`` with ``planes`` a float32 numpy
    array."""
    ir = np.asarray(ir, dtype=np.float32)
    if ir.ndim != 3:
        raise ValueError(f"ir must be [Cin, Cout, L], got shape {ir.shape}")
    cin, cout, length = ir.shape
    if not (1 <= cin <= MAXINP):
        raise ValueError(f"number of inputs ({cin}) is out of range")
    if not (1 <= cout <= MAXOUT):
        raise ValueError(f"number of outputs ({cout}) is out of range")
    if size is None:
        size = length
    if size > MAXSIZE:
        raise ValueError(f"convolver size ({size}) is out of range")
    if length > size:
        raise ValueError(f"impulse response ({length}) longer than size ({size})")
    if fragm is None:
        fragm = derive_fragm(size)
    p = num_partitions(size, fragm)

    padded = np.zeros((cin, cout, p * fragm), dtype=np.float64)
    padded[:, :, :length] = ir
    parts = padded.reshape(cin, cout, p, fragm)
    spec = np.fft.fft(parts, n=2 * fragm, axis=-1)
    spec = permute_spectrum(spec, 2 * fragm, half=(layout == "half"))
    # [Cin, Cout, P, K] -> [P, Cin, Cout, 2, K] real/imag planes.
    spec = np.transpose(spec, (2, 0, 1, 3))
    planes = np.stack([spec.real, spec.imag], axis=3).astype(np.float32)
    return planes, fragm, size
