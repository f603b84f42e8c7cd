"""Engine-wide constants and the uniform-partitioning policy.

The reference derives its convolution block length ("fragment") from the
zita-convolver quantum limits and pins a *uniform* partitioning —
quantum = minpart = maxpart = fragm (reference: zita-fconfig.cc:74-94).
These constants reproduce that policy exactly; they are the contract the
engine compiles against.
"""

from __future__ import annotations

# zita-convolver engine limits, as checked by the reference's config
# compiler (reference: zita-fconfig.cc:49-72, zita-config.h:61).
MAXINP = 64  # Convproc::MAXINP — max input channels
MAXOUT = 64  # Convproc::MAXOUT — max output channels
MAXSIZE = 0x100000  # 1,048,576 taps — max impulse-response length

# Convproc partition-size limits (zita-convolver.h in the upstream
# library; used by the fragment derivation at zita-fconfig.cc:74-77).
MINPART = 64
MAXQUANT = 8192

# Hilbert impulse synthesis length bounds (reference: zita-config.cc:227-229).
MIN_HILBERT = 64
MAX_HILBERT = 65536


def derive_fragm(size: int) -> int:
    """Block length for a filter of ``size`` taps.

    Reproduces the reference's selection loop (zita-fconfig.cc:74-77):
    start at MAXQUANT and halve while the fragment is still larger than
    MINPART and at least twice the filter size.  Note the reference
    *ignores* the partition-size field of ``/convolver/new`` — only the
    maxsize field matters.
    """
    if size <= 0:
        raise ValueError(f"filter size must be positive, got {size}")
    fragm = MAXQUANT
    while fragm > MINPART and fragm >= 2 * size:
        fragm //= 2
    return fragm


def num_partitions(size: int, fragm: int) -> int:
    """ceil(size / fragm) — partitions of the uniform scheme."""
    return -(-size // fragm)
