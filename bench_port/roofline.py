"""The least time one engine step could take on an NVIDIA H100 SXM.

Counted from the cell's shapes alone: what any implementation of the
step must move or compute, whatever kernels run it.  Bytes are each
input read once and each output written once, over 3.35 TB/s; operations
are the MAC and the real FFTs, over 67 TFLOP/s fp32 (the CUDA cores; the
engine's -90 dB budget rules out the tensor cores' TF32).  The bound is
the larger of the two.  Spectra count ``n/2 + 1`` complex bins, the
fewest a real transform of ``n`` points needs, not the padded layout a
program may store, so a later layout cannot read above 100%.

Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

PEAK_BYTES = 3.35e12  # B/s, HBM3 of one H100 SXM (NVIDIA data sheet)
PEAK_FP32 = 67e12  # FLOP/s, fp32 outside the tensor cores (data sheet)
F32 = 4


def fft_ops(n: int) -> float:
    """Operations of one real FFT of ``n`` points, counted as the
    textbook 2.5*n*log2(n)."""
    return 2.5 * n * math.log2(n)


@dataclasses.dataclass(frozen=True)
class Step:
    """Shapes of one step: ``streams`` x ``blocks`` blocks of ``fragm``
    samples through a uniformly partitioned filter of ``partitions``
    partitions and ``cin`` x ``cout`` channel pairs; ``filters`` distinct
    filters among the streams."""

    streams: int
    blocks: int
    partitions: int
    cin: int
    cout: int
    fragm: int
    filters: int = 1

    @property
    def n(self) -> int:
        return 2 * self.fragm

    @property
    def bins(self) -> int:
        return self.n // 2 + 1

    def byte_parts(self) -> dict:
        s, t, p, b = self.streams, self.blocks, self.partitions, self.fragm
        spec = 2 * F32 * self.bins  # one complex spectrum
        return {
            "x": s * t * self.cin * b * F32,
            "y": s * t * self.cout * b * F32,
            "history_read": s * (p - 1) * self.cin * spec,
            "history_written": s * min(t, p - 1) * self.cin * spec,
            "tail": 2 * s * self.cout * b * F32,
            "filter_spectra": self.filters * p * self.cin * self.cout * spec,
        }

    def op_parts(self) -> dict:
        s, t = self.streams, self.blocks
        return {
            "mac": 8.0 * s * t * self.partitions * self.cin * self.cout * self.bins,
            "fft": s * t * (self.cin + self.cout) * fft_ops(self.n),
        }

    @property
    def bytes(self) -> float:
        return float(sum(self.byte_parts().values()))

    @property
    def flops(self) -> float:
        return float(sum(self.op_parts().values()))

    def bound(self) -> dict:
        """Both bounds in ms and which one bounds the step."""
        bytes_ms = 1e3 * self.bytes / PEAK_BYTES
        ops_ms = 1e3 * self.flops / PEAK_FP32
        return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
