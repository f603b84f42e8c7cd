"""The control: the reference put in the program's place, on operands
rounded to TF32, the precision below the configurations' float32 with
TF32 off.  A run through it has to come out not correct.

Each step convolves every stream's input with its filter's dense
response (``Setup.dense_irs``, the reference's, built from the IRs the
benchmark made) by overlap-save in float64 with ``torch.fft``, the input
and the response rounded to TF32 first (10 explicit mantissa bits, to
nearest even, as the tensor cores round float32).  The input history of
each stream is carried from step to step, silent before the first.  It
imports nothing of the program and launches none of its kernels.
"""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 rounded to TF32."""
    u = x.float().contiguous().view(torch.int32)
    lsb = (u >> 13) & 1
    return ((u + 0x0FFF + lsb) & -8192).view(torch.float32)


class Driver:
    def __init__(self, setup):
        dev = setup.device
        self.h = [tf32(torch.as_tensor(ir, device=dev)).double() for ir in setup.dense_irs]
        self.rows = [(f, torch.as_tensor([s for s, a in enumerate(setup.assign) if a == f],
                                         device=dev))
                     for f in sorted(set(setup.assign))]
        cin, self.cout, size = self.h[0].shape
        self.keep = size - 1
        self.hist = torch.zeros((setup.streams, cin, self.keep), dtype=torch.float64,
                                device=dev)
        self.spectra = {}

    def _spectra(self, f: int, nfft: int) -> torch.Tensor:
        if (f, nfft) not in self.spectra:
            self.spectra[f, nfft] = torch.fft.rfft(self.h[f], nfft)
        return self.spectra[f, nfft]

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One step on ``x`` [S, T, Cin, fragm]; returns y [S, T, Cout, fragm]."""
        s, t, cin, fragm = x.shape
        n = t * fragm
        seg = torch.cat([self.hist, tf32(x).double().permute(0, 2, 1, 3).reshape(s, cin, n)],
                        dim=-1)
        self.hist = seg[..., n:]
        nfft = 1 << (seg.shape[-1] - 1).bit_length()
        xf = torch.fft.rfft(seg, nfft)
        y = torch.empty((s, self.cout, n), dtype=torch.float64, device=x.device)
        for f, rows in self.rows:
            hf = self._spectra(f, nfft)  # [Cin, Cout, K]
            xr = xf.index_select(0, rows)
            yf = sum(xr[:, i, None, :] * hf[i] for i in range(cin))
            y[rows] = torch.fft.irfft(yf, nfft)[..., self.keep : self.keep + n]
        return y.float().reshape(s, self.cout, t, fragm).permute(0, 2, 1, 3)

    def close(self) -> None:
        self.hist = None
        self.spectra = {}
