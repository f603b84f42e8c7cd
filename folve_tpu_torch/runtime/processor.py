"""SoundProcessor — the host-side block pump around the device engine.

Behavioral twin of the reference's sound-processor.{h,cc} (and of the
JAX package's processor): owns one compiled filter and one stream's
convolution state, fills a ``fragm``-frame input block from a decode
source, runs the device step lazily on first write, supports partial
output writes (``pending_writes``) for the gapless split, and tracks the
max output value for clipping detection.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from folve_tpu_torch.engine.device import resolve_device
from folve_tpu_torch.engine.stream import (
    StreamState,
    fused_filter,
    init_state,
    single_chunk_step,
)
from folve_tpu_torch.filters.compiler import (
    CompiledFilter,
    FilterCompileError,
    compile_config_file,
)
from folve_tpu_torch.utils.profiling import LatencyStats, span


def _quantize(y: torch.Tensor, bits: int) -> torch.Tensor:
    """Device-side PCM quantization, bit-identical to the host encoders'
    float64 path: the scale is a power of two, so ``y * scale`` is exact
    in float32 and round-half-even (``torch.round``) picks the same
    integer either way.  Returns int16 for <= 16 bits, else packed
    3-byte little-endian lanes (uint8 [..., 3]; see :func:`_unpack24`)."""
    scale = float(1 << (bits - 1))
    q = torch.clamp(torch.round(y * scale), -scale, scale - 1.0)
    if bits <= 16:
        return q.to(torch.int16)
    qi = q.to(torch.int32)
    return torch.stack(
        [qi & 0xFF, (qi >> 8) & 0xFF, (qi >> 16) & 0xFF], dim=-1
    ).to(torch.uint8)


def _unpack24(out: np.ndarray) -> np.ndarray:
    """Host-side inverse of the packed-lane quantize: uint8 [..., 3]
    little-endian -> sign-extended int32 [...]."""
    if out.dtype == np.uint8 and out.ndim >= 1 and out.shape[-1] == 3:
        v = (out[..., 0].astype(np.int32)
             | (out[..., 1].astype(np.int32) << 8)
             | (out[..., 2].astype(np.int32) << 16))
        return (v << 8) >> 8  # sign-extend bit 23
    return out


def _is_quantized(y: torch.Tensor) -> bool:
    return not y.dtype.is_floating_point


def _mtime(path: str) -> float:
    try:
        return os.stat(path).st_mtime
    except OSError:
        return 0.0


def _to_host_async(y: torch.Tensor):
    """Start the device->host copy of ``y`` into pinned memory; returns
    ``(host_tensor, event)`` (event None when ``y`` is already on the
    host).  The copy runs behind the work already queued on the stream."""
    if not y.is_cuda:
        return y, None
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    host.copy_(y, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class _Inflight:
    """One dispatched-but-unemitted bulk chunk (the pipeline depth is 1).

    Either ``future`` (DeviceScheduler path, resolves to (state, y)) or
    ``y`` (direct path: a host tensor being filled by an async copy that
    ``event`` marks) is set.  ``sink``/``r`` say where and how much to
    emit."""

    __slots__ = ("future", "y", "event", "r", "qbits", "sink")

    def __init__(self, future, y, event, r: int, qbits: Optional[int], sink):
        self.future = future
        self.y = y
        self.event = event
        self.r = r
        self.qbits = qbits
        self.sink = sink


class SoundProcessor:
    def __init__(self, compiled: CompiledFilter, config_file: str,
                 scheduler=None):
        self.config_file = config_file
        self.config_file_timestamp = _mtime(config_file)
        self.bank = compiled.bank
        # Optional DeviceScheduler: routes block work into batched device
        # steps shared with other concurrently-pumping streams.
        self.scheduler = scheduler
        self.latency = LatencyStats()
        # The bank as the fused kernel takes it (None when the bank
        # cannot take the fused route), once per processor.
        self._fused = fused_filter(self.bank)
        self._state = init_state(self.bank, device=self.bank.device)
        b = self.bank.fragm
        self._in_buf = np.zeros((b, self.bank.ninp), dtype=np.float32)
        self._input_pos = 0
        self._out_buf: Optional[np.ndarray] = None  # [fragm, cout]
        self._output_pos = -1  # <0: needs Process()
        self._max_out = 0.0
        # One-deep bulk-pump pipeline (see pump_chunk).
        self._inflight: Optional[_Inflight] = None
        # Wall-time breakdown of the bulk path (dispatch / D2H / encode).
        self.dispatch_s = 0.0
        self.fetch_s = 0.0
        self.encode_s = 0.0

    # -- introspection ----------------------------------------------------

    @property
    def input_channels(self) -> int:
        return self.bank.ninp

    @property
    def output_channels(self) -> int:
        return self.bank.nout

    @property
    def fragm(self) -> int:
        return self.bank.fragm

    def pending_writes(self) -> int:
        """Frames already processed but not yet written (gapless split)."""
        if self._output_pos < 0:
            return 0
        return self.fragm - self._output_pos

    def is_input_buffer_complete(self) -> bool:
        return self._input_pos == self.fragm

    def max_output_value(self) -> float:
        # Read-only peek: a pending scheduler step's state is read off its
        # future without consuming the pipeline.
        st = self._state
        fl = self._inflight
        fut = fl.future if fl is not None else None
        if fut is not None:
            st = fut.result()[0]
        return max(self._max_out, float(st.max_abs))

    def reset_max_values(self) -> None:
        """Clear only the clipping monitor; the convolution state (hist
        and tail) is untouched."""
        self._resolve_inflight_state()
        self._max_out = 0.0
        st = self._state
        self._state = StreamState(hist_re=st.hist_re, hist_im=st.hist_im,
                                  tail=st.tail,
                                  max_abs=torch.zeros_like(st.max_abs))

    def config_still_up_to_date(self) -> bool:
        """False once the config file's mtime has changed."""
        return self.config_file_timestamp == _mtime(self.config_file)

    # -- factory ----------------------------------------------------------

    @classmethod
    def create(cls, config_file: str, samplerate: int, channels: int,
               device="cuda") -> Optional["SoundProcessor"]:
        """Compile a config for this stream shape; None on a config that
        does not compile (:class:`FilterCompileError`) or cannot be read
        (``OSError``).  Any other error, a missing card or a CUDA error
        among them, propagates."""
        dev = resolve_device(device)
        try:
            compiled = compile_config_file(config_file, fsamp=samplerate,
                                           device=dev)
        except (FilterCompileError, OSError):
            return None
        del channels  # the config's /convolver/new channel counts govern
        return cls(compiled, config_file)

    # -- block pump -------------------------------------------------------

    def _resolve_inflight_state(self) -> None:
        """Fold a pending scheduler step's new state into ``_state``
        without emitting its audio (the emit stays queued)."""
        fl = self._inflight
        if fl is not None and fl.future is not None:
            state, y = fl.future.result()
            self._state = state
            fl.y, fl.future = y, None

    def _step(self, x: np.ndarray, n_valid: int):
        return single_chunk_step(self.bank, self._state, x, n_valid,
                                 fused=self._fused)

    def _emit(self, fl: _Inflight) -> None:
        """Fetch one pipelined chunk to the host and hand it to its sink."""
        y, ev = fl.y, fl.event
        if fl.future is not None:
            state, y = fl.future.result()
            self._state = state
        if ev is None:
            if fl.qbits is not None and not _is_quantized(y):
                y = _quantize(y, fl.qbits)
            y, ev = _to_host_async(y)
        with span("pump.fetch", stream=id(self)):
            t0 = time.perf_counter()
            if ev is not None:
                ev.synchronize()
            out = _unpack24(y.numpy())
            t1 = time.perf_counter()
            self.fetch_s += t1 - t0
        with span("pump.encode", stream=id(self)):
            tb = out.shape[0]
            out = out.transpose(0, 2, 1).reshape(tb * self.fragm, -1)
            fl.sink(out[: fl.r])
            self.encode_s += time.perf_counter() - t1

    def drain_pipeline(self) -> None:
        """Emit the pipelined chunk, if any.  Every non-bulk path that
        reads or writes convolution state or output order calls this
        first."""
        fl = self._inflight
        if fl is None:
            return
        self._inflight = None
        with self.latency.timer():
            self._emit(fl)

    def fill_buffer(self, source) -> int:
        """Read up to the missing part of the current block from
        ``source.read_float``.  Resets processed-but-unwritten output."""
        self.drain_pipeline()
        needed = self.fragm - self._input_pos
        assert needed > 0, "call write_processed() before refilling"
        self._output_pos = -1
        with span("pump.decode", stream=id(self)):
            data = source.read_float(needed)
        r = data.shape[0]
        if r:
            self._in_buf[self._input_pos : self._input_pos + r] = data
        self._input_pos += r
        return r

    def _process(self, quantize_bits: Optional[int] = None) -> None:
        """Zero-pad the tail, run the device step, fetch the output.
        ``quantize_bits``: quantize on the device (None when the block
        may be split across a gapless handover)."""
        assert self._inflight is None, "bulk pipeline must be drained first"
        if self._input_pos < self.fragm:
            self._in_buf[self._input_pos :] = 0.0
        x = self._in_buf.T[None]  # [1, Cin, fragm]
        with self.latency.timer():
            with span("pump.dispatch", stream=id(self)):
                t0 = time.perf_counter()
                if self.scheduler is not None:
                    fut = self.scheduler.submit(
                        self.bank, self._state, x, int(self._input_pos),
                        stream=id(self), quantize_bits=quantize_bits,
                    )
                    self._state, y = fut.result()
                else:
                    self._state, y = self._step(x, self._input_pos)
                if quantize_bits is not None and not _is_quantized(y):
                    y = _quantize(y, quantize_bits)
                t1 = time.perf_counter()
                self.dispatch_s += t1 - t0
            with span("pump.fetch", stream=id(self)):
                self._out_buf = _unpack24(y[0].cpu().numpy()).T  # [fragm, Cout]
                self.fetch_s += time.perf_counter() - t1
        self._output_pos = 0

    def pump_chunk(self, source, sink, max_blocks: int,
                   quantize_bits: Optional[int] = None) -> int:
        """Read, convolve and write up to ``max_blocks`` full blocks in
        one device step, pipelined one deep: chunk N is dispatched, then
        chunk N-1 is fetched and handed to ``sink`` while N runs.
        ``quantize_bits``: hand the sink PCM integers (int16, or int32
        from packed 24-bit lanes) quantized on the device.  Requires a
        clean block boundary.  Returns frames consumed (0 = use the
        single-block path)."""
        assert self._input_pos == 0 and self.pending_writes() == 0
        self._output_pos = -1
        b = self.fragm
        with span("pump.decode", stream=id(self)):
            data = source.read_float(max_blocks * b)
        r = data.shape[0]
        if r == 0:
            self.drain_pipeline()
            return 0
        t = -(-r // b)
        padded = np.zeros((t * b, self.bank.ninp), dtype=np.float32)
        padded[:r] = data
        x = np.ascontiguousarray(
            padded.reshape(t, b, self.bank.ninp).transpose(0, 2, 1))
        with self.latency.timer():
            prev = self._inflight
            with span("pump.dispatch", stream=id(self)):
                t0 = time.perf_counter()
                if self.scheduler is not None:
                    if prev is not None and prev.future is not None:
                        # Chain the state and queue chunk N-1's quantize and
                        # copy ahead of chunk N.
                        state, y = prev.future.result()
                        self._state = state
                        if prev.qbits is not None and not _is_quantized(y):
                            y = _quantize(y, prev.qbits)
                        prev.y, prev.event = _to_host_async(y)
                        prev.future, prev.qbits = None, None
                    fut = self.scheduler.submit(
                        self.bank, self._state, x, r, stream=id(self),
                        quantize_bits=quantize_bits,
                    )
                    self._inflight = _Inflight(fut, None, None, r, quantize_bits,
                                               sink)
                else:
                    self._state, y = self._step(x, r)
                    if quantize_bits is not None:
                        y = _quantize(y, quantize_bits)
                    y, ev = _to_host_async(y)
                    self._inflight = _Inflight(None, y, ev, r, None, sink)
                self.dispatch_s += time.perf_counter() - t0
            if prev is not None:
                self._emit(prev)  # D2H + encode of N-1 overlap chunk N
        return r

    def write_processed(self, sink, sample_count: int,
                        quantize_bits: Optional[int] = None) -> None:
        """Lazily process, then emit up to ``sample_count`` frames to
        ``sink(frames)``; partial writes leave the rest pending."""
        if self._output_pos < 0:
            self._process(quantize_bits)
        assert sample_count <= self.fragm - self._output_pos
        if sample_count > 0:
            sink(self._out_buf[self._output_pos : self._output_pos + sample_count])
        self._output_pos += sample_count
        if self._output_pos == self.fragm:
            self._input_pos = 0

    def drop_inflight(self) -> None:
        """Release a still-pipelined chunk without emitting it (its
        stream was aborted); resolving the future releases the
        scheduler's batch references."""
        fl, self._inflight = self._inflight, None
        if fl is not None and fl.future is not None:
            try:
                fl.future.result()
            except Exception:
                pass

    def reset(self) -> None:
        """Re-arm for a fresh stream: clears convolution state, the
        clipping monitor and the latency counters."""
        self.drop_inflight()
        self._state = init_state(self.bank, device=self.bank.device)
        self._max_out = 0.0
        self._input_pos = 0
        self._output_pos = -1
        self._out_buf = None
        self.latency = LatencyStats()
        self.dispatch_s = self.fetch_s = self.encode_s = 0.0
