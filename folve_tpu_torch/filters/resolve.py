"""Filter-config discovery: per-format file resolution and config-dir scan.

Reproduces the reference's two lookup schemes:

* config file resolution, most-specific-first (processor-pool.cc:51-69;
  README.md:204-218):
      filter-<rate>-<channels>-<bits>.conf
      filter-<rate>-<channels>.conf
      filter-<rate>.conf
* base-dir scanning for the selectable filter set, with '' meaning
  pass-through, and ../-escape sanitization via realpath prefix checks
  (folve-filesystem.cc:184-210, :261-287).
"""

from __future__ import annotations

import os
from typing import Optional, Set


def resolve_filter_config(
    config_dir: str, rate: int, channels: int, bits: int
) -> Optional[str]:
    """Most-specific matching config file in ``config_dir``, or None."""
    candidates = [
        f"filter-{rate}-{channels}-{bits}.conf",
        f"filter-{rate}-{channels}.conf",
        f"filter-{rate}.conf",
    ]
    for name in candidates:
        path = os.path.join(config_dir, name)
        if os.access(path, os.R_OK):
            return path
    return None


def sanitize_config_subdir(base_config_dir: str, subdir: str) -> Optional[str]:
    """Canonicalize ``subdir`` relative to the base config dir.

    Returns the sanitized relative subdir ('' = base itself), or None if
    it does not exist, is not a directory, or escapes the base dir via
    ../ or symlink tricks (folve-filesystem.cc:184-210).
    """
    base = os.path.realpath(base_config_dir)
    try:
        verified = os.path.realpath(os.path.join(base, subdir))
    except OSError:
        return None
    if not (verified == base or verified.startswith(base + os.sep)):
        return None
    if not os.path.isdir(verified):
        return None
    if verified == base:
        return ""
    return verified[len(base) + 1 :]


def list_config_dirs(base_config_dir: str) -> Set[str]:
    """All selectable filter names; always includes '' (pass-through)
    (folve-filesystem.cc:265-287)."""
    result = {""}
    try:
        entries = os.listdir(base_config_dir)
    except OSError:
        return result
    for name in entries:
        if name in (".", ".."):
            continue
        sanitized = sanitize_config_subdir(base_config_dir, name)
        if sanitized is not None and sanitized:
            result.add(sanitized)
    return result
