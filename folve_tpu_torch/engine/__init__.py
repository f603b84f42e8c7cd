"""Device engine: partitioned FFT convolution in PyTorch."""

from folve_tpu_torch.engine.constants import (
    MAXINP,
    MAXOUT,
    MAXQUANT,
    MAXSIZE,
    MINPART,
    derive_fragm,
    num_partitions,
)
from folve_tpu_torch.engine.filter_bank import FilterBank, compile_filter_bank
from folve_tpu_torch.engine.stream import (
    StreamState,
    batched_chunk_step,
    block_step,
    chunk_step,
    init_state,
    reset_state,
    serving_chunk_step,
    shared_filter_chunk_step,
    single_chunk_step,
)

__all__ = [
    "MAXINP",
    "MAXOUT",
    "MAXQUANT",
    "MAXSIZE",
    "MINPART",
    "derive_fragm",
    "num_partitions",
    "FilterBank",
    "compile_filter_bank",
    "StreamState",
    "batched_chunk_step",
    "block_step",
    "chunk_step",
    "init_state",
    "reset_state",
    "serving_chunk_step",
    "shared_filter_chunk_step",
    "single_chunk_step",
]
