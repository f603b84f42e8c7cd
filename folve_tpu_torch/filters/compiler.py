"""Filter compiler: FilterSpec -> dense impulse response -> FilterBank.

Impulse accumulation follows the reference's config compiler
(zita-config.cc:55-279) against a dense ``[Cin, Cout, size]`` IR tensor:
impulses on one in/out pair accumulate, and windowing and latency
compensation match line for line.  The spectra are computed on the host
(bit-identical to the JAX package's) and placed on the requested device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.filter_bank import FilterBank, compute_spectra_planes
from folve_tpu_torch.filters.zita_parser import (
    CopyOp,
    DiracOp,
    FilterSpec,
    HilbertOp,
    ReadOp,
    ZitaConfigError,
    parse_config,
)


class FilterCompileError(Exception):
    pass


@dataclasses.dataclass
class CompiledFilter:
    """Host-side compiled filter: dense IR plus the device FilterBank."""

    ir: np.ndarray  # [Cin, Cout, size] float32
    bank: FilterBank
    fsamp: int
    warnings: List[str]
    # Host copy of bank.h_spec (never fetched back from the device).
    host_spec: Optional[np.ndarray] = None
    # True when any impulse file was a WAVEX ambisonic B-format IR.
    ambisonic: bool = False

    @property
    def fragm(self) -> int:
        return self.bank.fragm


def _default_loader(path: str):
    from folve_tpu_torch import audio

    data, info = audio.read_audio(path)
    return data, info.rate, info.ambisonic


class _AbortOther(Exception):
    pass


def compile_spec(
    spec: FilterSpec,
    fsamp: int,
    latency: int = 0,
    loader: Optional[Callable] = None,
    device="cuda",
) -> CompiledFilter:
    """Accumulate all impulse ops into a dense IR and compile it onto
    ``device``.  ``fsamp`` is used only for the rate-mismatch warning
    (the reference does not resample IRs)."""
    dev = resolve_device(device)
    loader = loader or _default_loader
    if spec.convolver is None or spec.convolver.size == 0:
        raise FilterCompileError(f"{spec.path}: no convolver defined")
    conv = spec.convolver
    size = conv.size
    ir = np.zeros((conv.ninp, conv.nout, size), dtype=np.float64)
    warnings = list(spec.warnings)
    flags = {"ambisonic": False}

    def warn(line, msg):
        warnings.append(f"{spec.path}:{line}: {msg}")

    try:
        for op in spec.ops:
            if isinstance(op, ReadOp):
                _apply_read(ir, op, spec, fsamp, latency, loader, warn,
                            flags)
            elif isinstance(op, DiracOp):
                _apply_dirac(ir, op, latency, warn)
            elif isinstance(op, HilbertOp):
                _apply_hilbert(ir, op, latency, warn)
            elif isinstance(op, CopyOp):
                ir[op.dst_inp - 1, op.dst_out - 1] += ir[op.src_inp - 1, op.src_out - 1]
    except _AbortOther:
        # The ERR_OTHER quirk: remaining ops dropped, the partial filter
        # still compiles (zita-config.cc:306,345).
        pass

    planes, fragm, size = compute_spectra_planes(ir.astype(np.float32), size=size)
    bank = FilterBank(h_spec=torch.from_numpy(planes).to(dev), fragm=fragm,
                      size=size)
    return CompiledFilter(
        ir=ir.astype(np.float32), bank=bank, fsamp=fsamp, warnings=warnings,
        host_spec=planes, ambisonic=flags["ambisonic"],
    )


def compile_config_file(
    path: str,
    fsamp: int,
    latency: int = 0,
    loader: Optional[Callable] = None,
    device="cuda",
) -> CompiledFilter:
    """Parse and compile a jconvolver config file onto ``device``."""
    try:
        spec = parse_config(path)
    except ZitaConfigError as e:
        raise FilterCompileError(str(e)) from e
    return compile_spec(spec, fsamp=fsamp, latency=latency, loader=loader,
                        device=device)


def _apply_read(ir, op: ReadOp, spec, fsamp, latency, loader, warn,
                flags=None):
    size = ir.shape[2]
    delay, offset = op.delay, op.offset
    # Latency compensation (zita-config.cc:75-89).
    if latency:
        if delay >= latency:
            delay -= latency
        else:
            removed = latency - delay
            delay = 0
            offset += removed
            warn(op.line, f"First {removed} frames removed by latency compensation.")
    try:
        loaded = loader(op.path)
    except Exception as e:  # unreadable file: abort-but-succeed (ERR_OTHER)
        warn(op.line, f"Unable to open '{op.path}': {e}")
        raise _AbortOther()
    data, rate = loaded[0], loaded[1]
    # 3-tuple loaders carry the WAVEX ambisonic B-format marking;
    # 2-tuple custom loaders stay valid.
    if flags is not None and len(loaded) > 2 and loaded[2]:
        flags["ambisonic"] = True
    if rate != fsamp:
        warn(op.line, f"Sample rate ({rate}) of '{op.path}' does not match.")
    nfram, nchan = data.shape
    if not (1 <= op.channel <= nchan):
        warn(op.line, "Channel not available.")
        raise _AbortOther()
    if offset > nfram:
        warn(op.line, "Can't seek to offset.")
        raise _AbortOther()
    length = op.length if op.length else nfram - offset
    if length > size - delay:
        length = size - delay
        warn(op.line, "Data truncated.")
    length = min(length, nfram - offset)
    if length <= 0:
        return
    seg = data[offset : offset + length, op.channel - 1].astype(np.float64)
    ir[op.inp - 1, op.out - 1, delay : delay + length] += op.gain * seg


def _apply_dirac(ir, op: DiracOp, latency, warn):
    size = ir.shape[2]
    if op.delay < latency:
        warn(op.line, "Dirac pulse removed: delay < latency.")
        return
    delay = op.delay - latency
    if delay < size:
        ir[op.inp - 1, op.out - 1, delay] += op.gain


def _apply_hilbert(ir, op: HilbertOp, latency, warn):
    """Windowed Hilbert kernel synthesis (zita-config.cc:212-259)."""
    size = ir.shape[2]
    length = op.length
    if op.delay < latency + length // 2:
        warn(op.line, "Hilbert impulse removed: delay < latency + length/2.")
        return
    delay = op.delay - (latency + length // 2)
    h = length // 2
    hdata = np.zeros(length, dtype=np.float64)
    gain = op.gain * 2.0 / math.pi
    i = np.arange(1, h, 2)
    v = (gain / i) * (0.43 + 0.57 * np.cos(i * math.pi / h))
    hdata[h + i] = -v
    hdata[h - i] = v
    end = min(delay + length, size)
    if end <= delay:
        return
    ir[op.inp - 1, op.out - 1, delay:end] += hdata[: end - delay]
